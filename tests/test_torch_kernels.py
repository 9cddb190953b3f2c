"""Parity of the port's kernel modules with the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_ops.py and
tests/test_pallas_stats.py do). Inputs are made with numpy from a seed and
handed to both. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diart_tpu.ops.pallas_lstm import _tm_reference
from diart_tpu.ops.pallas_lstm import lstm_sweep_tm as jax_lstm_sweep_tm
from diart_tpu.ops.pallas_stats import fused_linear_stats as jax_fused_linear_stats
from diart_tpu.ops.pallas_stats import linear_stats_reference as jax_linear_stats_reference
from diart_tpu_torch.ops.linear_stats import fused_linear_stats
from diart_tpu_torch.ops.lstm_sweep import lstm_sweep_tm


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sweep_inputs(seed, time, batch, hidden):
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(time, 2, batch, 4 * hidden)).astype(np.float32)
    w_hh = rng.normal(scale=0.3 / np.sqrt(hidden / 8), size=(2, 4 * hidden, hidden))
    return proj, w_hh.astype(np.float32)


# f32: atol 1e-5 — both sides compute the same f32 recurrence; only the
# summation order of the h @ w_hh product differs.
@pytest.mark.parametrize("block", [8, 0])
@pytest.mark.parametrize("hidden", [8, 64, 128])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("time", [16, 21])
def test_lstm_sweep_matches_pallas(time, batch, hidden, block):
    proj, w_hh = _sweep_inputs(time * 100 + batch * 10 + hidden, time, batch, hidden)
    want = np.asarray(
        jax_lstm_sweep_tm(jnp.asarray(proj), jnp.asarray(w_hh), interpret=True, block=block)
    )
    got = lstm_sweep_tm(torch.from_numpy(proj), torch.from_numpy(w_hh)).numpy()
    assert got.shape == (time, 2, batch, hidden)
    np.testing.assert_allclose(got, want, atol=1e-5)


# bf16 stream: both sides round h to bf16 before the recurrent product and
# store bf16 outputs; a last-bit difference in the f32 gate sum can flip one
# bf16 rounding of an output in [-1, 1] (one bf16 ulp there is <= 2**-8),
# which then feeds later steps — atol 1e-2 holds that.
@pytest.mark.parametrize("block", [8, 0])
def test_lstm_sweep_bf16_matches_pallas(block):
    proj, w_hh = _sweep_inputs(7, 21, 3, 128)
    proj_bf = jnp.asarray(proj).astype(jnp.bfloat16)
    want = np.asarray(
        jax_lstm_sweep_tm(proj_bf, jnp.asarray(w_hh), interpret=True, block=block).astype(
            jnp.float32
        )
    )
    got = lstm_sweep_tm(torch.from_numpy(proj).to(torch.bfloat16), torch.from_numpy(w_hh))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_lstm_sweep_matches_scan_reference():
    proj, w_hh = _sweep_inputs(3, 17, 2, 8)
    want = np.asarray(_tm_reference(jnp.asarray(proj), jnp.asarray(w_hh)))
    got = lstm_sweep_tm(torch.from_numpy(proj), torch.from_numpy(w_hh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_lstm_sweep_rejects_bad_shapes():
    proj, w_hh = _sweep_inputs(0, 4, 1, 8)
    with pytest.raises(ValueError):
        lstm_sweep_tm(torch.from_numpy(proj[:, :1]), torch.from_numpy(w_hh))
    with pytest.raises(ValueError):
        lstm_sweep_tm(torch.from_numpy(proj), torch.from_numpy(w_hh[:, :, :4]))


def _stats_inputs(seed, batch, time, c_in, channels, speakers):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    x = f(batch, time, c_in)
    w = f(c_in, channels, scale=0.1)
    b = f(channels, scale=0.1)
    scale = 1.0 + f(channels, scale=0.1)
    shift = f(channels, scale=0.1)
    weights = (1.0 / (1.0 + np.exp(-f(batch, speakers, time)))).astype(np.float32)
    return x, w, b, scale, shift, weights


STATS_SHAPES = [(3, 37, 24, 300, 1), (2, 50, 16, 128, 6), (2, 29, 64, 1500, 4)]


# f32: rtol 1e-5 / atol 1e-4, the tolerance of tests/test_pallas_stats.py
# (sums over T of products of O(1) values, in another order).
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_linear_stats_matches_pallas_f32(shape):
    args = _stats_inputs(sum(shape), *shape)
    want_k = jax_fused_linear_stats(*map(jnp.asarray, args), interpret=True)
    want_r = jax_linear_stats_reference(*map(jnp.asarray, args))
    got = fused_linear_stats(*map(torch.from_numpy, args))
    for g, wk, wr in zip(got, want_k, want_r):
        assert g.dtype == torch.float32 and g.shape == (shape[0], shape[4], shape[3])
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=1e-5, atol=1e-4)


# bf16 X: the Pallas kernel and the port both round W to bf16 and multiply
# exactly in f32, so they agree to the f32 tolerance; the unfused reference
# keeps W in f32, so against it the tolerance of tests/test_pallas_stats.py's
# bf16 case applies.
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_linear_stats_matches_pallas_bf16(shape):
    x, *rest = _stats_inputs(sum(shape) + 1, *shape)
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    want_k = jax_fused_linear_stats(x_bf, *map(jnp.asarray, rest), interpret=True)
    want_r = jax_linear_stats_reference(x_bf, *map(jnp.asarray, rest))
    got = fused_linear_stats(
        torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, rest)
    )
    for g, wk, wr, atol in zip(got, want_k, want_r, (2e-1, 5e-1)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=2e-2, atol=atol)


def test_linear_stats_rejects_bad_shapes():
    args = [torch.from_numpy(a) for a in _stats_inputs(0, 2, 9, 8, 16, 2)]
    with pytest.raises(ValueError):
        fused_linear_stats(args[0], args[1][:4], *args[2:])
    with pytest.raises(ValueError):
        fused_linear_stats(*args[:5], args[5][:, :, :4])
