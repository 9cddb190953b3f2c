"""The port's model families as the engine's arms, against diart_tpu's
engine on the CPU: ``tpu/resnet34``, ``tpu/titanet`` and ``tpu/xvect-sb``
as the embedding of ``MultiStreamEngine`` beside the small ``tpu/pyannet``,
with and without the mel frame ring (kaldi, nemo, speechbrain at 24 mels),
and the powerset PyanNet as its segmentation, whose decode runs inside the
step. Weights are the JAX registry's flax init carried by
``load_flax_params``; the blocks come from a numpy seed.
"""

import numpy as np
import pytest
import torch

from diart_tpu import precision as jax_precision
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu_torch import MultiStreamEngine, SegmentationModel
from diart_tpu_torch.precision import Precision

import fakes
from test_torch_families import (
    ENGINE_KW,
    FAMILIES,
    KINDS,
    PS_PARAMS,
    SEG_KW,
    _tree,
    family_pairs_of,
    jax_registry,
)
from test_torch_families import powerset_pair  # noqa: F401  (a fixture)
from test_torch_pipeline import fake_embedding


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def family_pairs():
    return family_pairs_of(sorted(FAMILIES))


# per hop: audio mask, run mask; stream 1 pauses one hop, stream 2 three
AUDIO = [[1, 1, 1], [1, 1, 1], [1, 0, 1], [1, 1, 0], [1, 1, 0], [1, 1, 0], [1, 1, 1], [1, 1, 1]]


def _drive(engine, to_np, seed=5):
    blocks = np.random.default_rng(seed).normal(scale=0.1, size=(len(AUDIO), 3, 8000)).astype(np.float32)
    state, outs = engine.init_state(), []
    for i, (blk, audio) in enumerate(zip(blocks, AUDIO)):
        audio = np.array(audio, bool)
        state, out = engine.step(state, blk, audio_mask=audio, run_mask=audio & (i >= 3))
        outs.append(tuple(to_np(t) for t in out))
    return outs, state


@pytest.fixture(scope="module")
def segmentation_pair():
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=8000, **SEG_KW)
    return jseg, SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=_tree(jseg), **SEG_KW)


# aggregated / newest scores within 1e-4: the same f32 forward, sums in
# another order; the clustering decisions that select them are identical
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_engine_matches_jax(family_pairs, segmentation_pair, name, ring):
    (jemb, pemb), (jseg, pseg) = family_pairs[name], segmentation_pair
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb,
                                precision=jax_precision.Precision(fbank_ring=ring), **ENGINE_KW)
    peng = MultiStreamEngine(pseg, pemb, precision=Precision(fbank_ring=ring), **ENGINE_KW)
    assert peng.embedding_dim == 32
    if ring:
        assert jeng._fring is not None and tuple(peng._fring) == tuple(jeng._fring)
        assert peng._fring.kind == KINDS[name]
    else:
        assert jeng._fring is None and peng._fring is None
    want, jstate = _drive(jeng, np.asarray)
    got, pstate = _drive(peng, lambda t: t.numpy())
    for hop, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4, err_msg=f"aggregated, hop {hop}")
        np.testing.assert_allclose(g[1], w[1], atol=1e-4, err_msg=f"newest, hop {hop}")
        np.testing.assert_array_equal(g[2], w[2], err_msg=f"chunk_index, hop {hop}")
    assert any(np.abs(w[0]).sum() > 0 for w in want)  # speakers were mapped
    np.testing.assert_array_equal(pstate.center_active.numpy(), np.asarray(jstate.center_active))
    np.testing.assert_allclose(pstate.centers.numpy(), np.asarray(jstate.centers), atol=1e-4)




def test_powerset_engine_matches_jax(powerset_pair):
    """The decode runs inside the port's step; the engine's frame grid and
    speaker count are the decoded ones; binary outputs, at least one and at
    most two speakers a frame; newest and aggregated scores equal to the
    JAX engine's at every frame whose top-1 - top-2 log-probability margin
    exceeds 1e-4 (10x the f32 error of the two forwards), and the
    aggregated scores at every hop where all frames do; the smallest
    margin is printed."""
    jseg, pseg = powerset_pair
    assert pseg.powerset == jseg.powerset == (3, 2)
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=fakes.fake_embedding(), batch_size=2, **PS_PARAMS)
    peng = MultiStreamEngine(pseg, fake_embedding(), batch_size=2, **PS_PARAMS)
    assert peng.num_local == jeng.num_local == 3
    assert peng.num_frames == jeng.num_frames
    rng = np.random.default_rng(0)
    jstate, pstate, margin, compared = jeng.init_state(), peng.init_state(), np.inf, 0
    for i in range(6):
        blocks = rng.normal(scale=0.1, size=(2, peng.step_samples)).astype(np.float32)
        run = np.full((2,), i + 1 >= 4)
        jstate, jout = jeng.step(jstate, blocks, run_mask=run)
        pstate, pout = peng.step(pstate, blocks, run_mask=run)
        with torch.no_grad():
            raw = pseg.module(pstate.audio[:, None]).numpy()  # class log-probabilities
        top2 = np.sort(raw, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-4  # (B, frames)
        margin = min(margin, float((top2[..., 1] - top2[..., 0]).min()))
        np.testing.assert_array_equal(pout.newest.numpy()[clear], np.asarray(jout.newest)[clear],
                                      err_msg=f"hop {i}")
        compared += int(clear.sum())
        if clear.all():
            np.testing.assert_allclose(pout.aggregated.numpy(), np.asarray(jout.aggregated), atol=1e-6)
    print(f"min top-1 - top-2 margin over the engine's windows: {margin:.3e}; "
          f"{compared} window frames compared")
    assert compared > 0.9 * 6 * 2 * peng.num_frames
    scores = peng._seg(pstate.audio[:, None]).numpy()
    assert set(np.unique(scores)) <= {0.0, 1.0}
    assert (scores.sum(-1) >= 1).all() and (scores.sum(-1) <= 2).all()
