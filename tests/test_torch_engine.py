"""End-to-end parity of the port's MultiStreamEngine with diart_tpu's.

Both engines run the same small registry models (the flax init carried
into the port by ``load_flax_params``) over the same seeded audio, with
warm-up, a paused stream and a slot reset, as tests/test_engine.py does.
The port runs on the CPU, i.e. with its kernels' plain versions.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4, batch_size=2)
# thresholds low enough that the random models' ~0.5 activations map speakers
DIAR_KW = dict(ENGINE_KW, tau_active=0.45, rho_update=0.05)
HOPS = 6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    jemb = JaxEmbeddingModel.from_registry("tpu/xvector", init_samples=8000, **EMB_KW).load()
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb), **EMB_KW)
    return (jseg, jemb), (pseg, pemb)


def _schedule():
    """Per hop: (audio_mask, run_mask, reset mask after the hop). Streams warm
    up for duration/step - 1 = 1 hop; stream 1 pauses at hop 3; stream 0's
    slot is reset after hop 4 and warms up again."""
    plan = []
    for i in range(HOPS):
        audio = np.ones(2, bool)
        run = np.full(2, i >= 1)
        if i == 3:
            audio[1] = run[1] = False
        if i == 5:
            run[0] = False  # the reset slot warms up again
        reset = np.array([i == 4, False])
        plan.append((audio, run, reset))
    return plan


def _run(engine, blocks, to_np):
    state = engine.init_state()
    outs = []
    for blk, (audio, run, reset) in zip(blocks, _schedule()):
        state, out = engine.step(state, blk, audio_mask=audio, run_mask=run)
        outs.append(tuple(to_np(t) for t in out))
        if reset.any():
            state = engine.reset_streams(state, reset)
    return outs, tuple(to_np(t) for t in state)


def _blocks(dtype):
    rng = np.random.default_rng(21)
    if dtype == "int16":
        return rng.integers(-3000, 3000, size=(HOPS, 2, 4000)).astype(np.int16)
    return rng.normal(scale=0.1, size=(HOPS, 2, 4000)).astype(np.float32)


# aggregated/newest scores: atol 1e-4 — sigmoid outputs of the same f32
# forward, differing only in summation order through SincNet, the LSTM and
# the TDNN stack; the clustering targets that select them are identical.
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_engine_matches_jax(models, dtype):
    (jseg, jemb), (pseg, pemb) = models
    blocks = _blocks(dtype)
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, **DIAR_KW)
    peng = MultiStreamEngine(pseg, pemb, **DIAR_KW)
    assert peng.num_frames == jeng.num_frames and peng.geometry.num_out == jeng.geometry.num_out
    want, want_state = _run(jeng, blocks, np.asarray)
    got, got_state = _run(peng, blocks, lambda t: t.numpy())
    for hop, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4, err_msg=f"aggregated, hop {hop}")
        np.testing.assert_allclose(g[1], w[1], atol=1e-4, err_msg=f"newest, hop {hop}")
        np.testing.assert_array_equal(g[2], w[2], err_msg=f"chunk_index, hop {hop}")
    assert any(np.abs(w[0]).sum() > 0 for w in want)  # speakers were mapped
    # StreamState fields: audio, ring, centers, center_active, initialized, chunk_count
    # the JAX window is phase-major (B, stride, samples/stride): sample i at
    # [b, i % stride, i // stride]; the port keeps the plain (B, samples)
    want_audio = np.swapaxes(want_state[0], 1, 2).reshape(2, -1)
    np.testing.assert_allclose(got_state[0], want_audio, atol=1e-7)
    np.testing.assert_allclose(got_state[1], want_state[1], atol=1e-4)
    np.testing.assert_allclose(got_state[2], want_state[2], atol=1e-4)
    for i in (3, 4, 5):
        np.testing.assert_array_equal(got_state[i], want_state[i])


def test_vad_engine_matches_jax(models):
    (jseg, _), (pseg, _) = models
    blocks = _blocks("float32")
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=None, **ENGINE_KW)
    peng = MultiStreamEngine(pseg, None, **ENGINE_KW)
    assert peng.is_vad
    want, _ = _run(jeng, blocks, np.asarray)
    got, _ = _run(peng, blocks, lambda t: t.numpy())
    for hop, (g, w) in enumerate(zip(got, want)):
        assert g[0].shape == w[0].shape and g[0].shape[-1] == 1
        np.testing.assert_allclose(g[0], w[0], atol=1e-5, err_msg=f"hop {hop}")


def test_probe_and_retuning_match_jax(models):
    """probe_frame_scores agrees with the JAX probe (and leaves the state
    alone); retuned hyper-parameters take effect without a new engine."""
    (jseg, jemb), (pseg, pemb) = models
    blocks = _blocks("float32")
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, **ENGINE_KW)
    peng = MultiStreamEngine(pseg, pemb, **ENGINE_KW)
    tuned = dict(tau_active=0.4, rho_update=0.05, delta_new=0.8, gamma=2.0, beta=5.0)
    jeng.set_hyperparameters(**tuned)
    peng.set_hyperparameters(**tuned)
    jstate, pstate = jeng.init_state(), peng.init_state()
    for blk in blocks[:2]:
        jstate, _ = jeng.step(jstate, blk)
        pstate, _ = peng.step(pstate, blk)
    before = pstate.audio.clone()
    jseg_out, jemb_out = jeng.probe_frame_scores(jstate, blocks[2])
    pseg_out, pemb_out = peng.probe_frame_scores(pstate, blocks[2])
    assert torch.equal(pstate.audio, before)
    np.testing.assert_allclose(pseg_out.numpy(), np.asarray(jseg_out), atol=1e-5)
    np.testing.assert_allclose(pemb_out.numpy(), np.asarray(jemb_out), atol=1e-4)
    assert peng.gamma == 2.0 and peng.beta == 5.0


def test_port_imports_no_jax():
    """Every module of diart_tpu_torch imports without jax, flax or diart_tpu."""
    code = (
        "import pkgutil, importlib, sys, diart_tpu_torch\n"
        "for m in pkgutil.walk_packages(diart_tpu_torch.__path__, 'diart_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diart_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is the path under test elsewhere")
    with pytest.raises(RuntimeError, match="no GPU"):
        SegmentationModel.from_registry("tpu/pyannet", **SEG_KW)
    with pytest.raises(RuntimeError, match="no GPU"):
        EmbeddingModel.from_registry("tpu/xvector", **EMB_KW)
