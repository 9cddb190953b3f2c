"""Module-by-module parity of the port (diart_tpu_torch) with diart_tpu.

Weights: the flax init of the small registry models the JAX engine tests
use, carried into the port by ``load_flax_params``. Inputs: numpy from a
seed. Everything runs on the CPU in f32, so the tolerances below cover
summation order and transcendental rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.models.embedding import stats_from_moments as jax_stats_from_moments
from diart_tpu.models.embedding import weighted_stats_pool as jax_weighted_stats_pool
from diart_tpu.models.lstm import BiLSTM as JaxBiLSTM
from diart_tpu.models.sincnet import SincNet as JaxSincNet
from diart_tpu.models.sincnet import sinc_filters as jax_sinc_filters
from diart_tpu.ops import aggregation as jax_aggregation
from diart_tpu.ops import functional as jax_functional
from diart_tpu.ops.assignment import assign_rows as jax_assign_rows
from diart_tpu.ops.clustering import ClusteringParams as JaxClusteringParams
from diart_tpu.ops.clustering import cluster_step as jax_cluster_step
from diart_tpu.ops.clustering import init_state as jax_init_state
from diart_tpu_torch.models import EmbeddingModel, SegmentationModel
from diart_tpu_torch.models.embedding import stats_from_moments, weighted_stats_pool
from diart_tpu_torch.models.lstm import BiLSTM
from diart_tpu_torch.models.sincnet import SincNet, sinc_filters
from diart_tpu_torch.ops import aggregation, functional
from diart_tpu_torch.ops.assignment import assign_rows, assign_rows_host
from diart_tpu_torch.ops.clustering import ClusteringParams, cluster_step, init_state
from diart_tpu_torch.weights import load_flax_params

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    seg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    emb = JaxEmbeddingModel.from_registry("tpu/xvector", init_samples=8000, **EMB_KW).load()
    return seg, emb


@pytest.fixture(scope="module")
def port_models(jax_models):
    seg, emb = jax_models
    return (
        SegmentationModel.from_registry(
            "tpu/pyannet", device="cpu", flax_params=_numpy_tree(seg.params), **SEG_KW
        ),
        EmbeddingModel.from_registry(
            "tpu/xvector", device="cpu", flax_params=_numpy_tree(emb.params), **EMB_KW
        ),
    )


def _wave(seed, batch=2, samples=8000):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=(batch, 1, samples)).astype(np.float32)


# ----------------------------------------------------------------------- #
def test_sinc_filters_match():
    """f32 synthesis on both sides; the sin/cos arguments reach ~400 rad,
    where an argument ulp is ~3e-5 rad, so taps (|tap| <= ~1) agree to
    atol 1e-4, not bit for bit."""
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 4000, 40).astype(np.float32)
    band = rng.uniform(0, 1000, 40).astype(np.float32)
    want = np.asarray(jax_sinc_filters(jnp.asarray(low), jnp.asarray(band)))
    got = sinc_filters(torch.from_numpy(low), torch.from_numpy(band)).numpy()
    assert got.shape == (80, 251)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sincnet_matches(jax_models):
    tree = _numpy_tree(jax_models[0].params["params"]["sincnet"])
    wave = _wave(1)
    want = np.asarray(JaxSincNet().apply({"params": tree}, jnp.asarray(wave)))
    port = load_flax_params(SincNet(), tree)
    got = port(torch.from_numpy(wave)).detach().numpy()
    assert got.shape == want.shape == (2, 60, 26)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bilstm_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 13, 6)).astype(np.float32)  # (B, T, F)
    module = JaxBiLSTM(hidden_size=8, num_layers=2, use_pallas=False, keep_time_major=True)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(module.apply(params, jnp.asarray(x)))  # (T, B, 2H)
    port = load_flax_params(BiLSTM(6, hidden_size=8, num_layers=2), _numpy_tree(params))
    got = port(torch.from_numpy(x).transpose(0, 1)).detach().numpy()
    assert got.shape == (13, 3, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pyannet_matches(jax_models, port_models):
    wave = _wave(3)
    want = np.asarray(jax_models[0](wave))
    got = port_models[0](torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (2, 26, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_xvector_trunk_and_head_match(jax_models, port_models):
    jemb, pemb = jax_models[1], port_models[1]
    wave = _wave(4, samples=16000)
    rng = np.random.default_rng(5)
    weights = rng.uniform(0.01, 1.0, size=(2, 3, 41)).astype(np.float32)

    # trunk: the full TDNN stack (fused head off) against the JAX trunk
    want_frames = np.asarray(jemb.trunk_fn()(jemb.params, jnp.asarray(wave)))
    got_frames = pemb.module.trunk(torch.from_numpy(wave), fused_head=False).detach().numpy()
    assert got_frames.shape == want_frames.shape
    np.testing.assert_allclose(got_frames, want_frames, rtol=1e-4, atol=1e-4)

    # the port's fused trunk/head split against the JAX standard head
    want = np.asarray(
        jemb.head_fn()(jemb.params, jnp.asarray(want_frames), jnp.asarray(weights))
    )
    with torch.no_grad():
        frames = pemb.trunk(torch.from_numpy(wave))
        assert frames.shape[-1] == 512  # stops before the 1x1 tdnn4
        got = pemb.head(frames, torch.from_numpy(weights)).numpy()
    assert got.shape == want.shape == (2, 3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_stats_pooling_matches():
    rng = np.random.default_rng(6)
    frames = rng.normal(size=(2, 30, 12)).astype(np.float32)
    weights = rng.uniform(0, 1, size=(2, 4, 30)).astype(np.float32)
    weights[0, 1] = 0.0  # an all-zero speaker: std clamps to exactly 0
    want = np.asarray(jax_weighted_stats_pool(jnp.asarray(frames), jnp.asarray(weights)))
    got = weighted_stats_pool(torch.from_numpy(frames), torch.from_numpy(weights)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    s1, s2 = rng.normal(size=(2, 2, 5)), rng.uniform(0, 3, size=(2, 2, 5))
    v1, v2 = rng.uniform(0.5, 2, size=(2, 2)), rng.uniform(0, 0.5, size=(2, 2))
    args = [a.astype(np.float32) for a in (s1, s2, v1, v2)]
    want = np.asarray(jax_stats_from_moments(*map(jnp.asarray, args)))
    got = stats_from_moments(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------- #
def test_functional_matches():
    rng = np.random.default_rng(7)
    seg = rng.uniform(0, 1, size=(2, 20, 3)).astype(np.float32)
    for gamma, beta in ((3.0, 10.0), (2.0, 5.0)):
        want = np.asarray(jax_functional.overlapped_speech_penalty(jnp.asarray(seg), gamma, beta))
        got = functional.overlapped_speech_penalty(torch.from_numpy(seg), gamma, beta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    emb = rng.normal(size=(3, 8)).astype(np.float32)
    emb[1] = 0.0  # zero norm -> NaN, as in the JAX package
    want = np.asarray(jax_functional.normalize_embeddings(jnp.asarray(emb), 1.0))
    got = functional.normalize_embeddings(torch.from_numpy(emb), 1.0).numpy()
    assert got.shape == want.shape == (1, 3, 8)  # the 2-D branch adds a batch axis
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    x, y = rng.normal(size=(4, 8)), rng.normal(size=(5, 8))
    x, y = x.astype(np.float32), y.astype(np.float32)
    want = np.asarray(jax_functional.cosine_cdist(jnp.asarray(x), jnp.asarray(y)))
    got = functional.cosine_cdist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)

    w = rng.uniform(0, 1, size=(2, 20, 3)).astype(np.float32)
    w[1, :, 2] = 0.5  # flat column -> 1e-8
    want = np.asarray(jax_functional.min_max_normalize(jnp.asarray(w), axis=-2))
    got = functional.min_max_normalize(torch.from_numpy(w), dim=-2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("latency", [0.5, 1.0, 2.0, 5.0])
def test_aggregation_matches(latency):
    want_geo = jax_aggregation.build_geometry(5.0, 0.5, latency, 293)
    geo = aggregation.build_geometry(5.0, 0.5, latency, 293)
    for field in ("num_windows", "num_out", "first_num_out"):
        assert getattr(geo, field) == getattr(want_geo, field)
    for field in ("indices", "weights", "first_indices"):
        np.testing.assert_array_equal(getattr(geo, field), getattr(want_geo, field))

    rng = np.random.default_rng(int(latency * 10))
    w = geo.num_windows
    buffers = rng.uniform(0, 1, size=(3, w, 293, 4)).astype(np.float32)
    count = np.array([1, max(1, w // 2), w + 3], np.int32)
    want = np.stack([
        np.asarray(jax_aggregation.aggregate(want_geo, jnp.asarray(b), jnp.int32(c)))
        for b, c in zip(buffers, count)
    ])
    got = aggregation.aggregate(geo, torch.from_numpy(buffers), torch.from_numpy(count)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,cols", [(1, 5), (2, 2), (3, 7), (4, 20)])
def test_assign_rows_identical(rows, cols):
    """Same columns as the JAX solver on every matrix (sentinel entries
    included), and optimal against scipy."""
    rng = np.random.default_rng(rows * 100 + cols)
    cost = rng.uniform(0, 2, size=(16, rows, cols)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.3] = 1e10
    want = np.stack([np.asarray(jax_assign_rows(jnp.asarray(c))) for c in cost])
    got = assign_rows(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)
    real = np.where(cost >= 1e9, 0.0, cost)
    for c, r, g in zip(cost, real, got):
        host = assign_rows_host(c)
        assert np.isclose(r[np.arange(rows), g].sum(), r[np.arange(rows), host].sum())


def test_assign_rows_unmap_rerun_case():
    """The joint solve of [[.5,.6],[.75,1.3]] pairs row0->col1; once row 1
    is invalidated (over delta .7) the re-solve returns row 0 to col 0."""
    cost = torch.tensor([[[0.5, 0.6], [0.75, 1.3]]])
    assert assign_rows(cost).tolist() == [[1, 0]]
    cost2 = torch.tensor([[[0.5, 0.6], [1e10, 1e10]]])
    assert assign_rows(cost2)[0, 0].item() == 0


def _simulate(rng, num_chunks, num_local=3, dim=16, num_true=5):
    true_emb = rng.normal(size=(num_true, dim))
    true_emb /= np.linalg.norm(true_emb, axis=1, keepdims=True)
    chunks = []
    for _ in range(num_chunks):
        seg = rng.uniform(0, 0.45, (50, num_local))
        emb = rng.normal(scale=0.2, size=(num_local, dim))
        speakers = rng.integers(0, num_true, size=num_local)
        for k in range(num_local):
            if rng.uniform() < 0.7:
                seg[:, k] += rng.uniform(0.3, 0.55)
                emb[k] += true_emb[speakers[k]]
        chunks.append((np.clip(seg, 0, 1).astype(np.float32), emb.astype(np.float32)))
    return chunks


@pytest.mark.parametrize("delta", [1.0, 0.6])
def test_cluster_step_identical(delta):
    """4 streams x 30 chunks through both: identical targets and permuted
    scores at every chunk. delta 0.6 is the regime of the post-threshold
    re-solve (tests/test_ops.py's low-delta parity case)."""
    rng = np.random.default_rng(11 if delta == 1.0 else 12)
    streams = [_simulate(rng, 30) for _ in range(4)]
    tau, rho, max_spk = 0.5, 0.3, 6
    jparams = JaxClusteringParams(tau, rho, delta)
    jstep = jax.jit(jax.vmap(lambda s, seg, emb: jax_cluster_step(s, seg, emb, jparams)))
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (4,) + a.shape), jax_init_state(max_spk, 16)
    )
    state = init_state(4, max_spk, 16)
    params = ClusteringParams(tau, rho, delta)
    for t in range(30):
        seg = np.stack([s[t][0] for s in streams])
        emb = np.stack([s[t][1] for s in streams])
        jstate, jperm, jtgt = jstep(jstate, jnp.asarray(seg), jnp.asarray(emb))
        state, perm, tgt = cluster_step(state, torch.from_numpy(seg), torch.from_numpy(emb), params)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt), err_msg=f"chunk {t}")
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm), err_msg=f"chunk {t}")
        np.testing.assert_array_equal(state.active.numpy(), np.asarray(jstate.active))
        np.testing.assert_allclose(state.centers.numpy(), np.asarray(jstate.centers), atol=1e-5)


def test_cluster_step_nan_embeddings_ignored():
    params = ClusteringParams(0.5, 0.3, 1.0)
    seg = torch.full((1, 20, 2), 0.9)
    emb = torch.ones(1, 2, 8)
    emb[0, 1] = float("nan")
    _, _, targets = cluster_step(init_state(1, 4, 8), seg, emb, params)
    assert targets.tolist() == [[0, -1]]


def test_load_flax_params_is_strict(jax_models):
    tree = _numpy_tree(jax_models[0].params["params"]["sincnet"])
    del tree["norm1_scale"]
    with pytest.raises(RuntimeError, match="norm1_scale"):
        load_flax_params(SincNet(), tree)
