"""Parity of the port's ECAPA-TDNN slice with diart_tpu.

The speechbrain log-mel frontend and its incremental frame ring, the two
kernel modules (attention statistics, SE-Res2Block and its stage mode),
the ECAPA-TDNN trunk and head, and the engine with the frame ring are each
held against the JAX package on the CPU. Inputs come from numpy seeds;
weights are the flax init carried over by ``load_flax_params``. The port
runs its kernels' plain versions (CPU tensors); the JAX side runs its
Pallas kernels in interpret mode where the comparison is with the kernel.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.models import fbank as jax_fbank
from diart_tpu.ops.pallas_attn_stats import attentive_stats_reference as jax_attn_reference
from diart_tpu.ops.pallas_attn_stats import fused_attentive_stats as jax_fused_attn
from diart_tpu.ops.pallas_res2 import fused_se_res2_block as jax_fused_res2
from diart_tpu.ops.pallas_res2 import se_res2_block_reference as jax_res2_reference
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel
from diart_tpu_torch.models import fbank
from diart_tpu_torch.ops.attn_stats import fused_attentive_stats
from diart_tpu_torch.ops.se_res2 import fused_se_res2_block, kernel_operands, se_res2_staged
from diart_tpu_torch.precision import Precision
from diart_tpu_torch.weights import load_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
DURATION, STEP = 2.0, 0.5
CHUNK = int(DURATION * SR)
SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
ECAPA_KW = dict(embedding_dim=32, channels=32)
ENGINE_KW = dict(duration=DURATION, step=STEP, latency=STEP, sample_rate=SR, max_speakers=4,
                 batch_size=3, tau_active=0.45, rho_update=0.05)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(model):
    return jax.tree_util.tree_map(np.asarray, model.params)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ----------------------------------------------------------------------- #
# frontend


def test_speechbrain_log_mel_matches_jax():
    """Both sides build the basis and mel matrix in float64 numpy and run
    the DFT in true f32; the low-energy bins' dB values carry the f32
    cancellation of the DFT sums: atol 1e-3 dB."""
    np.testing.assert_array_equal(
        fbank.speechbrain_mel_matrix(80, 400, SR), jax_fbank.speechbrain_mel_matrix(80, 400, SR)
    )
    wave = np.random.default_rng(1).normal(scale=0.1, size=(2, 12345)).astype(np.float32)
    want = np.asarray(jax_fbank.speechbrain_log_mel(jnp.asarray(wave)))
    got = fbank.speechbrain_log_mel(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (2, 12345 // 160 + 1, 80)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("chunk,step", [(80000, 8000), (CHUNK, 8000)])
def test_fbank_ring_pieces_match_jax(chunk, step):
    """Geometry identical; block, edge and fill frames within 1e-3 dB."""
    spec = fbank.fbank_ring_spec("speechbrain", 80, SR, chunk, step)
    want_spec = jax_fbank.fbank_ring_spec("speechbrain", 80, SR, chunk, step)
    assert tuple(spec) == tuple(want_spec)
    np.testing.assert_array_equal(fbank.fbank_ring_fill(spec), jax_fbank.fbank_ring_fill(want_spec))
    rng = np.random.default_rng(2)
    tail = rng.normal(scale=0.1, size=(2, spec.tail_len)).astype(np.float32)
    block = rng.normal(scale=0.1, size=(2, step)).astype(np.float32)
    head = rng.normal(scale=0.1, size=(2, spec.head_len)).astype(np.float32)
    pairs = [
        (fbank.fbank_block_raw(spec, *_t(tail, block)), jax_fbank.fbank_block_raw(spec, tail, block)),
        (fbank.fbank_edge_left(spec, *_t(head)), jax_fbank.fbank_edge_left(spec, head)),
        (fbank.fbank_edge_right(spec, *_t(tail)), jax_fbank.fbank_edge_right(spec, tail)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_other_fbank_kinds_are_queued():
    """The kaldi and nemo kinds, once queued, are ported: their geometry and
    zero-signal fill equal JAX's (tests/test_torch_families.py holds their
    frames)."""
    for kind in ("kaldi", "nemo"):
        spec = fbank.fbank_ring_spec(kind, 80, SR, 80000, 8000)
        want = jax_fbank.fbank_ring_spec(kind, 80, SR, 80000, 8000)
        assert tuple(spec) == tuple(want)
        np.testing.assert_array_equal(fbank.fbank_ring_fill(spec), jax_fbank.fbank_ring_fill(want))


# ----------------------------------------------------------------------- #
# kernel #4: attention statistics


def _attn_inputs(seed, batch, time, channels, bottleneck, speakers):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(batch, time, channels)
    hidden = np.tanh(f(batch, time, bottleneck))
    w2 = f(bottleneck, channels) * 0.2
    b2 = f(channels) * 0.1
    weights = 1.0 / (1.0 + np.exp(-f(batch, speakers, time)))
    return x, hidden, w2, b2, weights.astype(np.float32)


ATTN_SHAPES = [(3, 37, 300, 64, 1), (2, 50, 128, 32, 6), (2, 41, 192, 128, 4)]


# f32: the tolerance of tests/test_pallas_attn_stats.py (f32 sums over T in
# another order): den rtol/atol 1e-5, s1/s2 rtol 1e-5 atol 1e-4.
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attn_stats_matches_pallas_f32(shape):
    args = _attn_inputs(sum(shape), *shape)
    got = fused_attentive_stats(*_t(*args))
    want_k = jax_fused_attn(*map(jnp.asarray, args), interpret=True)
    want_r = jax_attn_reference(*map(jnp.asarray, args))
    for g, wk, wr, atol in zip(got, want_k, want_r, (1e-5, 1e-4, 1e-4)):
        assert g.dtype == torch.float32 and tuple(g.shape) == (shape[0], shape[4], shape[2])
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=1e-5, atol=atol)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=1e-5, atol=atol)


# bf16 x: both sides read the same bf16 values exactly in f32, so the f32
# tolerance holds against the Pallas kernel fed the same bf16 x.
@pytest.mark.parametrize("shape", ATTN_SHAPES[:2])
def test_attn_stats_matches_pallas_bf16(shape):
    x, *rest = _attn_inputs(sum(shape) + 1, *shape)
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    got = fused_attentive_stats(torch.from_numpy(x).to(torch.bfloat16), *_t(*rest))
    want = jax_fused_attn(x_bf, *map(jnp.asarray, rest), interpret=True)
    for g, w, atol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=atol)


def test_attn_stats_rejects_bad_shapes():
    x, hidden, w2, b2, weights = _t(*_attn_inputs(0, 2, 9, 16, 8, 2))
    with pytest.raises(ValueError):
        fused_attentive_stats(x, hidden[:, :4], w2, b2, weights)
    with pytest.raises(ValueError):
        fused_attentive_stats(x, hidden, w2[:, :4], b2, weights)


# ----------------------------------------------------------------------- #
# kernel #5 and its stage mode (#6)


def _res2_params(seed, chans, scale, taps=3, hidden=32):
    """Unit-gain block parameters (0.5 / sqrt(fan_in) weight scales), the
    regime of tests/test_pallas_res2.py: larger random weights make the
    7-group cascade amplify f32 rounding noise far beyond any tolerance."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    mk = lambda *s: n(*s) * np.float32(0.5 / np.sqrt(s[-2]))
    width, groups = chans // scale, scale - 1
    return (
        mk(chans, chans), n(chans) * 0.1, 1 + 0.1 * n(chans), 0.1 * n(chans),
        n(groups, taps, width, width) * np.float32(0.5 / np.sqrt(taps * width)),
        0.1 * n(groups, width), 1 + 0.1 * n(groups, width), 0.1 * n(groups, width),
        mk(chans, chans), n(chans) * 0.1, 1 + 0.1 * n(chans), 0.1 * n(chans),
        mk(chans, hidden), 0.1 * n(hidden), mk(hidden, chans), 0.1 * n(chans),
    )


def _stage_debug():
    """scripts/res2_stage_debug.py, whose ``reference_stage`` is the JAX
    package's oracle of the stage mode."""
    path = os.path.join(ROOT, "scripts", "res2_stage_debug.py")
    spec = importlib.util.spec_from_file_location("res2_stage_debug", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BATCH, TIME, CHANS, SCALE = 2, 37, 128, 4


# f32: outputs O(1..10) after two 128-long contractions and the cascade;
# only the f32 summation order differs: rtol 1e-4, atol 1e-4.
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_se_res2_block_matches_pallas_f32(dilation):
    params = _res2_params(dilation, CHANS, SCALE)
    x = np.random.default_rng(10 + dilation).normal(size=(BATCH, TIME, CHANS)).astype(np.float32)
    got = fused_se_res2_block(torch.from_numpy(x), _t(*params), dilation).numpy()
    want_k = np.asarray(jax_fused_res2(jnp.asarray(x), tuple(map(jnp.asarray, params)), dilation, interpret=True))
    want_r = np.asarray(jax_res2_reference(jnp.asarray(x), *map(jnp.asarray, params), dilation))
    np.testing.assert_allclose(got, want_k, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_r, rtol=1e-4, atol=1e-4)


# bf16: both sides round the weights and every intermediate at the same
# points; an f32 sum in another order can flip one bf16 rounding (2**-8
# relative), which the later groups carry: atol 0.1 on outputs O(1..10),
# and the mean error stays at the bf16 rounding level (< 5e-3).
@pytest.mark.parametrize("dilation", [2, 4])
def test_se_res2_block_matches_pallas_bf16(dilation):
    params = _res2_params(20 + dilation, CHANS, SCALE)
    x = np.random.default_rng(30 + dilation).normal(size=(BATCH, TIME, CHANS)).astype(np.float32)
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    got = fused_se_res2_block(torch.from_numpy(x).to(torch.bfloat16), _t(*params), dilation)
    assert got.dtype == torch.bfloat16
    want = jax_fused_res2(x_bf, tuple(map(jnp.asarray, params)), dilation, interpret=True)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() <= 0.1 and err.mean() <= 5e-3, (err.max(), err.mean())


# every stage at each dilation, against the JAX stage oracle; stage 1 holds
# the reflect shift at both edges (what micro_roll checked). f32 as above.
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_se_res2_stages_match_reference_stage(dilation):
    debug = _stage_debug()
    params = _res2_params(40 + dilation, CHANS, SCALE)
    x = np.random.default_rng(50 + dilation).normal(size=(BATCH, TIME, CHANS)).astype(np.float32)
    for stage in range(SCALE + 1):
        got = se_res2_staged(torch.from_numpy(x), _t(*params), dilation, stage).numpy()
        want = np.asarray(debug.reference_stage(jnp.asarray(x), tuple(map(jnp.asarray, params)), dilation, stage))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"stage {stage}")
        if 0 < stage < SCALE - 1:
            assert not got[..., (stage + 1) * (CHANS // SCALE):].any()
    full = se_res2_staged(torch.from_numpy(x), _t(*params), dilation, SCALE - 1)
    assert full.shape == (BATCH, TIME, CHANS)


def test_se_res2_rejects_bad_params():
    params = _t(*_res2_params(0, CHANS, SCALE))
    x = torch.zeros(BATCH, TIME, CHANS)
    with pytest.raises(ValueError):
        fused_se_res2_block(x[..., :96], params, 2)
    with pytest.raises(ValueError):
        fused_se_res2_block(x, params[:15], 2)
    with pytest.raises(ValueError):
        fused_se_res2_block(x[:, :2], params, 4)  # too few frames to reflect-pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_res2_operands_match_the_tuple(dtype):
    """Operands laid out once give the same block and stages as the
    16-tuple, and are refused for another dtype."""
    params = _t(*_res2_params(60, CHANS, SCALE))
    x = torch.from_numpy(np.random.default_rng(61).normal(size=(BATCH, TIME, CHANS)).astype(np.float32))
    x = x.to(dtype)
    ops = kernel_operands(params, dtype)
    assert torch.equal(fused_se_res2_block(x, None, 3, operands=ops), fused_se_res2_block(x, params, 3))
    for stage in (0, 2):
        assert torch.equal(se_res2_staged(x, None, 3, stage, operands=ops), se_res2_staged(x, params, 3, stage))
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    with pytest.raises(TypeError, match="laid out"):
        fused_se_res2_block(x, None, 3, operands=kernel_operands(params, other))


# ----------------------------------------------------------------------- #
# the model


@pytest.fixture(scope="module")
def jax_ecapa():
    # parameter shapes do not depend on the init input's length
    return JaxEmbeddingModel.from_registry("tpu/ecapa", init_samples=8000, **ECAPA_KW).load()


@pytest.fixture(scope="module")
def ecapa_pair(jax_ecapa):
    pemb = EmbeddingModel.from_registry("tpu/ecapa", device="cpu", flax_params=_tree(jax_ecapa), **ECAPA_KW)
    return jax_ecapa, pemb


# f32: trunk outputs O(10) after the stem, three blocks and the MFA, f32
# sums in another order: atol 5e-4; embeddings atol 1e-4.
def test_ecapa_trunk_and_head_match_jax_f32(ecapa_pair):
    jemb, pemb = ecapa_pair
    rng = np.random.default_rng(3)
    wave = rng.normal(scale=0.1, size=(2, 1, 8000)).astype(np.float32)
    module = jemb.module
    want_t = np.asarray(module.apply(jemb.params, jnp.asarray(wave), method="trunk"))
    got_t = pemb.trunk(torch.from_numpy(wave))
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=5e-4)
    weights = rng.uniform(size=(2, 3, 30)).astype(np.float32)  # resampled to the trunk's 51 frames
    want_h = np.asarray(module.apply(jemb.params, jnp.asarray(want_t), jnp.asarray(weights), method="head"))
    got_h = pemb.head(torch.from_numpy(want_t), torch.from_numpy(weights))
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-4)
    # no weights: one uniform speaker, squeezed
    want_1 = np.asarray(module.apply(jemb.params, jnp.asarray(want_t), method="head"))
    np.testing.assert_allclose(pemb.head(torch.from_numpy(want_t)).numpy(), want_1, atol=1e-4)


def test_ecapa_matches_jax_fused_bf16(jax_ecapa, monkeypatch):
    """bf16 trunk: the port runs each block in the fused formulation (BN in
    f32, rounded once), so it is held against JAX's fused kernel (interpret
    mode), as tests/test_pallas_res2.py forces it. An f32 sum in another
    order flips a bf16 rounding now and then: the trunk (O(10)) within 0.25
    and its mean error at the bf16 rounding level. The head reads the bf16
    frames exactly and pools in f32: embeddings within 1e-4."""
    from diart_tpu import precision as jax_precision
    from diart_tpu.models.ecapa import EcapaTDNN as JaxEcapa

    jemb = jax_ecapa  # flax parameters are f32 whatever the compute dtype
    pemb = EmbeddingModel.from_registry(
        "tpu/ecapa", device="cpu", flax_params=_tree(jemb), dtype="bf16", **ECAPA_KW
    )
    rng = np.random.default_rng(4)
    wave = rng.normal(scale=0.1, size=(2, 1, 4800)).astype(np.float32)
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f == "pallas_res2")
    module = JaxEcapa(compute_dtype=jnp.bfloat16, **ECAPA_KW)
    want = module.apply(jemb.params, jnp.asarray(wave), method="trunk")
    got = pemb.trunk(torch.from_numpy(wave))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() <= 0.25 and err.mean() <= 2e-2, (err.max(), err.mean())
    weights = rng.uniform(size=(2, 3, 31)).astype(np.float32)
    want_h = module.apply(jemb.params, want, jnp.asarray(weights), method="head")
    frames = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
    got_h = pemb.head(frames, torch.from_numpy(weights))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4)


# ----------------------------------------------------------------------- #
# the engine with the mel frame ring


@pytest.fixture(scope="module")
def engine_models(jax_ecapa):
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    jemb = jax_ecapa
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=_tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/ecapa", device="cpu", flax_params=_tree(jemb), **ECAPA_KW)
    return (jseg, jemb), (pseg, pemb)


# per hop: audio mask, run mask, reset mask after the hop. Warm-up of
# duration/step - 1 = 3 hops; stream 1 pauses for one hop, stream 2 for
# three (longer than the edge margin); stream 0 is reset after hop 6 and
# warms up again.
AUDIO = [
    [1, 1, 1], [1, 1, 1], [1, 0, 1], [1, 1, 0], [1, 1, 0],
    [1, 1, 0], [1, 1, 1], [1, 1, 1], [1, 1, 1],
]


def _schedule():
    plan = []
    for i, audio in enumerate(AUDIO):
        audio = np.array(audio, bool)
        run = audio & (i >= 3)
        if i >= 7:
            run[0] = False  # the reset slot warms up again
        plan.append((audio, run, np.array([i == 6, False, False])))
    return plan


def _blocks():
    return np.random.default_rng(5).normal(scale=0.1, size=(len(AUDIO), 3, 8000)).astype(np.float32)


def _drive(engine, to_np):
    state, outs = engine.init_state(), []
    for blk, (audio, run, reset) in zip(_blocks(), _schedule()):
        state, out = engine.step(state, blk, audio_mask=audio, run_mask=run)
        outs.append(tuple(to_np(t) for t in out))
        if reset.any():
            state = engine.reset_streams(state, reset)
    return outs, state


# aggregated/newest scores and probed embeddings: atol 1e-4 — outputs of
# the same f32 forward, differing only in summation order; the clustering
# targets that select them are identical.
def test_ecapa_engine_matches_jax(engine_models):
    (jseg, jemb), (pseg, pemb) = engine_models
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, **ENGINE_KW)
    peng = MultiStreamEngine(pseg, pemb, **ENGINE_KW)
    assert jeng._fring is not None and tuple(peng._fring) == tuple(jeng._fring)
    want, jstate = _drive(jeng, np.asarray)
    got, pstate = _drive(peng, lambda t: t.numpy())
    for hop, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4, err_msg=f"aggregated, hop {hop}")
        np.testing.assert_allclose(g[1], w[1], atol=1e-4, err_msg=f"newest, hop {hop}")
        np.testing.assert_array_equal(g[2], w[2], err_msg=f"chunk_index, hop {hop}")
    assert any(np.abs(w[0]).sum() > 0 for w in want)  # speakers were mapped
    # the ring state: raw log-mel frames (dB) within 1e-3, samples exact
    np.testing.assert_allclose(pstate.audio["ring"].numpy(), np.asarray(jstate.audio["ring"]), atol=1e-3)
    for key in ("head", "tail"):
        np.testing.assert_array_equal(pstate.audio[key].numpy(), np.asarray(jstate.audio[key]))
    np.testing.assert_array_equal(pstate.center_active.numpy(), np.asarray(jstate.center_active))
    np.testing.assert_array_equal(pstate.chunk_count.numpy(), np.asarray(jstate.chunk_count))
    # probe_frame_scores agrees with the JAX probe and leaves the state alone
    before = {k: v.clone() for k, v in pstate.audio.items()}
    jseg_out, jemb_out = jeng.probe_frame_scores(jstate, _blocks()[0])
    pseg_out, pemb_out = peng.probe_frame_scores(pstate, _blocks()[0])
    assert all(torch.equal(pstate.audio[k], v) for k, v in before.items())
    np.testing.assert_allclose(pseg_out.numpy(), np.asarray(jseg_out), atol=1e-5)
    np.testing.assert_allclose(pemb_out.numpy(), np.asarray(jemb_out), atol=1e-4)


# the ring is the direct path computed incrementally: atol 5e-5, as
# tests/test_fbank_ring.py holds the JAX engine's two paths.
def test_ecapa_engine_ring_matches_direct(engine_models):
    _, (pseg, pemb) = engine_models
    ringed = MultiStreamEngine(pseg, pemb, **ENGINE_KW)
    direct = MultiStreamEngine(pseg, pemb, precision=Precision(fbank_ring=False), **ENGINE_KW)
    assert ringed._fring is not None and direct._fring is None
    assert not isinstance(direct.init_state().audio, dict)
    got, _ = _drive(ringed, lambda t: t.numpy())
    want, _ = _drive(direct, lambda t: t.numpy())
    for hop, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=5e-5, err_msg=f"aggregated, hop {hop}")
        np.testing.assert_allclose(g[1], w[1], atol=5e-5, err_msg=f"newest, hop {hop}")


def test_reset_restores_ring_fill(engine_models):
    """A reset slot's frame ring holds the zero-signal constant (-100 dB)
    again, as at init — not zero — and the other slots keep theirs."""
    _, (pseg, pemb) = engine_models
    engine = MultiStreamEngine(pseg, pemb, **ENGINE_KW)
    init = engine.init_state()
    assert torch.all(init.audio["ring"] == -100.0)
    state = init
    for blk in _blocks()[:2]:
        state, _ = engine.step(state, blk)
    state = engine.reset_streams(state, np.array([False, True, False]))
    for key, value in state.audio.items():
        assert torch.equal(value[1], init.audio[key][1]), key
    assert not torch.equal(state.audio["ring"][0], init.audio["ring"][0])


def test_ring_switch_applies_on_every_device():
    from diart_tpu_torch import precision

    with precision.use(Precision()):
        assert precision.enabled("fbank_ring", "cpu")
        assert not precision.enabled("bf16_lstm", "cpu")
    with precision.use(Precision.portable()):
        assert not precision.enabled("fbank_ring", "cpu")


# ----------------------------------------------------------------------- #
# the weight bridge and the registry


def test_load_flax_params_biasless_linear():
    """A bias-less Dense (ECAPA's att_global) loads into nn.Linear(bias=False);
    a tree leaf the module does not take still raises."""
    module = torch.nn.Sequential()
    module.add_module("att_global", torch.nn.Linear(6, 4, bias=False))
    module.add_module("att2", torch.nn.Linear(4, 3))
    rng = np.random.default_rng(6)
    tree = {
        "att_global": {"kernel": rng.normal(size=(6, 4)).astype(np.float32)},
        "att2": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                 "bias": rng.normal(size=3).astype(np.float32)},
    }
    load_flax_params(module, {"params": tree})
    np.testing.assert_array_equal(module.att_global.weight.detach().numpy(), tree["att_global"]["kernel"].T)
    np.testing.assert_array_equal(module.att2.bias.detach().numpy(), tree["att2"]["bias"])
    tree["att_global"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(KeyError, match="att_global"):
        load_flax_params(module, tree)


def test_ecapa_registry():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            EmbeddingModel.from_registry("tpu/ecapa")
    with pytest.raises(TypeError, match="unknown arguments"):
        EmbeddingModel.from_registry("tpu/ecapa", device="cpu", base_channels=8)
    model = EmbeddingModel.from_registry("tpu/ecapa", device="cpu", seed=0, **ECAPA_KW)
    assert model.fbank_ring_kind == "speechbrain" and model.num_mels == 80
    assert model.module.att_global.bias is None
    emb = model.head(model.trunk(torch.zeros(1, 1, 8000) + 0.01))
    assert emb.shape == (1, 32) and torch.isfinite(emb).all()
