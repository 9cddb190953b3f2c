"""The LSTM sweep's backward (``diart_tpu_torch.ops.lstm_sweep``) on the CPU.

``lstm_sweep_backward_reference`` (the plain version of the backward
kernel ``csrc/lstm_sweep_bwd.cu`` and the bulk products around it) against
autograd through ``lstm_sweep_reference``; ``SweepFunction``'s CPU backward
against ``jax.grad`` through ``diart_tpu.ops.pallas_lstm.lstm_sweep_tm``
in Pallas interpret mode (f32: the same function differentiated on both
sides); the kernel's layouts replayed in plain PyTorch; a whole
segmentation train step through ``SweepFunction`` against diart_tpu's.

Tolerances, relative to the largest gradient of any input:

* f32, against autograd through the plain version: 1e-5. The walk back
  through time has the forward's rounding points; only the order of the
  f32 sums differs (every step's recurrent product in one batched product,
  the weight gradient in one product over T x B rows).
* bf16, against the same: 1e-2. The gradient is rounded to bf16 where the
  plain version's casts round it (dproj, the hidden state's gradient each
  step, dw_hh); a last-bit difference of an f32 sum flips such a rounding
  now and then (2**-8 of that entry) and the flip feeds the earlier steps.
* f32, against ``jax.grad``: rtol 1e-4 with a floor of 1e-5, as
  ``tests/test_torch_train.py`` holds the other kernels' Functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.ops.pallas_lstm import lstm_sweep_tm as jax_lstm_sweep_tm
from diart_tpu.train import make_train_state as jax_make_train_state
from diart_tpu.train import pit_bce_loss as jax_pit_bce_loss
from diart_tpu.train import train_step as jax_train_step
from diart_tpu_torch.models import SegmentationModel
from diart_tpu_torch.ops import lstm_sweep
from diart_tpu_torch.train import make_train_state, train_step

from test_torch_families import jax_registry
from test_torch_train import _check_against_jax, _flat, _t, _tree

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (T, B, H): one step, one stream, the narrowest width, a width that is not
# a multiple of 16, and the bf16 route's widths (64, 128)
SHAPES = [(1, 1, 8), (1, 3, 8), (9, 1, 8), (11, 2, 20), (13, 3, 64), (7, 2, 128)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, time, batch, hidden, dtype):
    """Seeded numpy inputs: the gate stream in ``dtype``, w_hh (f32) at the
    scale of a trained layer, a cotangent in ``dtype``."""
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.normal(size=(time, 2, batch, 4 * hidden)).astype(np.float32)).to(dtype)
    w_hh = torch.from_numpy((rng.normal(size=(2, 4 * hidden, hidden)) * 0.3 / np.sqrt(hidden / 8)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(time, 2, batch, hidden)).astype(np.float32)).to(dtype)
    return proj, w_hh, cot


def _autograd(proj, w_hh, cot):
    """The plain version's output and autograd's gradients through it."""
    p, w = proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
    out = lstm_sweep.lstm_sweep_reference(p, w)
    return out.detach(), torch.autograd.grad(out, (p, w), cot)


def _err(got, want):
    scale = max(w.float().abs().max().item() for w in want)
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-B{}-H{}".format(*s))
@pytest.mark.parametrize("kind", list(DTYPES))
def test_backward_reference_matches_autograd(kind, shape):
    dtype = DTYPES[kind]
    proj, w_hh, cot = _inputs(sum(shape), *shape, dtype)
    out, want = _autograd(proj, w_hh, cot)
    got = lstm_sweep.lstm_sweep_backward_reference(proj, w_hh, out, cot)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert got[0].shape == proj.shape and got[1].shape == w_hh.shape
    assert all(torch.isfinite(g).all() for g in got)
    assert _err(got, want) <= TOL[dtype]


def test_backward_reference_keeps_w_hh_dtype():
    """dw_hh comes back in w_hh's dtype, rounded where the forward casts
    w_hh to the stream dtype."""
    proj, w_hh, cot = _inputs(1, 5, 2, 8, torch.bfloat16)
    out, want = _autograd(proj, w_hh.to(torch.bfloat16), cot)
    dproj, dw = lstm_sweep.lstm_sweep_backward_reference(proj, w_hh.to(torch.bfloat16), out, cot)
    assert dw.dtype == torch.bfloat16 and _err((dproj, dw), want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("block", [0, 8])
def test_sweep_function_cpu_backward_matches_jax(block):
    """The same function differentiated on both sides: diart_tpu's
    custom_vjp (jax.vjp of its lax.scan reference) and the port's walk back
    through time. block=8 runs the blocked Pallas kernel forward (T >= 2
    blocks)."""
    proj, w_hh, cot = _inputs(7, 19, 2, 8, torch.float32)
    p, w = proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
    out = lstm_sweep.SweepFunction.apply(p, w, None)
    assert type(out.grad_fn).__name__ == "SweepFunctionBackward"
    out.backward(cot)

    def loss(pj, wj):
        return jnp.sum(jax_lstm_sweep_tm(pj, wj, interpret=True, block=block).astype(jnp.float32) * cot.numpy())

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(proj.numpy()), jnp.asarray(w_hh.numpy()))
    scale = max(float(np.abs(np.asarray(x)).max()) for x in want)
    for got, ref in zip((p.grad, w.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_wrapper_under_grad_runs_the_walk_not_autograd(kind, monkeypatch):
    """On a CPU tensor, ``lstm_sweep_tm`` under grad mode is the
    ``SweepFunction``: its forward runs outside autograd and its backward
    is ``lstm_sweep_backward_reference``, once per call; the gradients are
    the plain backward's bits."""
    dtype = DTYPES[kind]
    proj, w_hh, cot = _inputs(3, 6, 2, 8, dtype)
    calls = []
    plain = lstm_sweep.lstm_sweep_backward_reference
    monkeypatch.setattr(lstm_sweep, "lstm_sweep_backward_reference", lambda *a: calls.append(1) or plain(*a))
    p, w = proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
    out = lstm_sweep.lstm_sweep_tm(p, w)
    assert type(out.grad_fn).__name__ == "SweepFunctionBackward"
    out.backward(cot)
    assert calls == [1]
    dproj, dw = plain(proj, w_hh, out.detach(), cot)
    assert torch.equal(p.grad, dproj) and torch.equal(w.grad, dw)
    # only the stream requires a gradient: w_hh gets none
    p2 = proj.clone().requires_grad_(True)
    lstm_sweep.lstm_sweep_tm(p2, w_hh).backward(cot)
    assert torch.equal(p2.grad, dproj) and w_hh.grad is None
    # no grad mode: the plain forward, no Function
    with torch.no_grad():
        assert lstm_sweep.lstm_sweep_tm(p, w).grad_fn is None


def test_backward_refuses_what_it_does_not_take():
    proj, w_hh, cot = _inputs(4, 3, 2, 8, torch.float32)
    out = lstm_sweep.lstm_sweep_reference(proj, w_hh)
    with pytest.raises(ValueError, match="shapes"):
        lstm_sweep.lstm_sweep_backward(proj, w_hh[:, :8], out, cot)
    with pytest.raises(ValueError, match="shapes"):
        lstm_sweep.lstm_sweep_backward(proj, w_hh, out, cot[:2])
    with pytest.raises(TypeError, match="stream dtype"):
        lstm_sweep.lstm_sweep_backward(proj.double(), w_hh, out, cot)
    with pytest.raises(TypeError, match="stream dtype"):
        lstm_sweep.lstm_sweep_backward(proj, w_hh, out.to(torch.bfloat16), cot)
    meta = [t.to("meta") for t in (proj, w_hh, out, cot)]
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_sweep.lstm_sweep_backward(*meta)
    with pytest.raises(ValueError, match="same device"):
        lstm_sweep.lstm_sweep_backward(proj, w_hh.to("meta"), out, cot)


def test_previous_hidden_states():
    """r(h_{s-1}) in natural time order: direction 0 reads the output one
    step earlier, direction 1 one step later; 0 at each one's first step."""
    out = torch.arange(5 * 2 * 3 * 4, dtype=torch.float32).view(5, 2, 3, 4).to(torch.bfloat16)
    hr = lstm_sweep._prev_hidden(out)
    assert hr.dtype == torch.float32 and hr.shape == (2, 5, 3, 4)
    assert torch.equal(hr[0, 0], torch.zeros(3, 4)) and torch.equal(hr[1, 4], torch.zeros(3, 4))
    assert torch.equal(hr[0, 1:], out[:-1, 0].float()) and torch.equal(hr[1, :-1], out[1:, 1].float())


@pytest.mark.parametrize("kind", list(DTYPES))
def test_backward_w_layout_replays_the_product(kind):
    """The kernel's W layouts, walked as the kernel walks them, give e = da W
    within f32 rounding. ``"column"`` (H = 20): [d][m // 4][j][m % 4] =
    w_hh[d][m][j] in the stream dtype, four chains over m % 4 summed (0 + 1)
    + (2 + 3). ``"split"`` (H = 128): [d][k][r][16 p + q][c] = W[d][g H +
    u][64 k + 4 q + c] for the unit-major row 16 p + r = 4 u + g, in f32
    (the stream dtype's values), a chain of 16 rows a part, the parts as a
    balanced tree."""
    dtype = DTYPES[kind]
    rng = np.random.default_rng(5)
    for hidden, batch in ((20, 3), (128, 2)):
        w_hh = torch.from_numpy(rng.normal(size=(2, 4 * hidden, hidden)).astype(np.float32))
        da = torch.from_numpy(rng.normal(size=(2, batch, 4 * hidden)).astype(np.float32))
        wp = lstm_sweep.pack_backward_w(w_hh, dtype)
        w = w_hh.to(dtype).float()
        if hidden == 20:
            assert lstm_sweep._backward_route(hidden) == "column"
            assert wp.shape == (2, hidden, hidden, 4) and wp.dtype == dtype and wp.is_contiguous()
            for m in (0, 1, 5, 4 * hidden - 1):
                assert torch.equal(wp[:, m // 4, :, m % 4].float(), w[:, m, :])
        else:
            assert lstm_sweep._backward_route(hidden) == "split"
            assert wp.shape == (2, 2, 16, 4 * hidden, 4) and wp.dtype == torch.float32 and wp.is_contiguous()
            for m, col in ((0, 0), (17, 5), (4 * hidden - 1, hidden - 1), (300, 70)):
                row = 4 * (m % hidden) + m // hidden  # unit-major: gate m // H of unit m % H
                p, r, k, q, c = row // 16, row % 16, col // 64, (col % 64) // 4, col % 4
                assert torch.equal(wp[:, k, r, 16 * p + q, c], w[:, m, col])
        e = lstm_sweep.backward_product(wp, da, hidden)
        want = torch.bmm(da, w)
        torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("hidden", [20, 64, 128, 256])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_backward_product_replays_the_sum_order(kind, hidden):
    """Each route's fixed sum order (``backward_product``: the split over
    parts, i.e. warps, and over the cluster's blocks, which own columns)
    against ``torch.bmm(da, W)`` in float64, within f32 rounding; the
    split route's parts one by one against their own float64 sums."""
    dtype = DTYPES[kind]
    rng = np.random.default_rng(hidden)
    batch = 3
    w_hh = torch.from_numpy((rng.normal(size=(2, 4 * hidden, hidden)) / np.sqrt(hidden)).astype(np.float32))
    da = torch.from_numpy(rng.normal(size=(2, batch, 4 * hidden)).astype(np.float32))
    wp = lstm_sweep.pack_backward_w(w_hh, dtype)
    w = w_hh.to(dtype).double()
    e = lstm_sweep.backward_product(wp, da, hidden)
    want = torch.bmm(da.double(), w)
    assert e.dtype == torch.float32 and e.shape == (2, batch, hidden)
    assert (e.double() - want).abs().max().item() <= 4 * hidden * 2.0**-24 * want.abs().max().item()
    if lstm_sweep._backward_route(hidden) == "split":
        # one part alone (units 4p .. 4p+3, every gate): da zero elsewhere
        part = torch.zeros_like(da)
        rows = [g * hidden + u for g in range(4) for u in range(12, 16)]
        part[:, :, rows] = da[:, :, rows]
        got = lstm_sweep.backward_product(wp, part, hidden).double()
        ref = torch.bmm(part.double(), w)
        assert (got - ref).abs().max().item() <= 16 * 2.0**-24 * ref.abs().max().item()


def _split_walk(proj, pre, dout, w_hh):
    """The split route's walk in plain PyTorch, step by step as the kernel
    computes it: phase A's gates, coefficients and the scan of c; phase B's
    cell update from them, e from ``backward_product`` on the packed W, one
    rounding to the stream dtype."""
    hidden = proj.shape[-1] // 4
    dt = proj.dtype
    wp = lstm_sweep.pack_backward_w(w_hh, dt)
    steps = lambda x: torch.stack([x[0], x[1].flip(0)])
    a = steps(proj.float().transpose(0, 1) + pre)  # (2, T, B, 4H), step order
    g_out = steps(dout.float().transpose(0, 1))
    i, f, g, o = (torch.sigmoid(a[..., :hidden]), torch.sigmoid(a[..., hidden:2 * hidden]),
                  torch.tanh(a[..., 2 * hidden:3 * hidden]), torch.sigmoid(a[..., 3 * hidden:]))
    k_i, k_g = g * (1 - i) * i, i * (1 - g * g)  # phase A's coefficients in pre
    c = torch.zeros_like(g_out[:, 0])
    k_f, tc = [], []
    for s in range(a.shape[1]):  # the scan thread
        k_f.append(c * (1 - f[:, s]) * f[:, s])
        c = f[:, s] * c + i[:, s] * g[:, s]
        tc.append(torch.tanh(c))
    e = dc_next = f_next = torch.zeros_like(c)
    da = [None] * a.shape[1]
    for s in reversed(range(a.shape[1])):
        dh = g_out[:, s] + e
        dc = dh * (o[:, s] * (1 - tc[s] * tc[s])) + dc_next * f_next
        da[s] = torch.cat([dc * k_i[:, s], dc * k_f[s], dc * k_g[:, s], dh * (tc[s] * (1 - o[:, s]) * o[:, s])], -1)
        e = lstm_sweep.backward_product(wp, da[s], hidden).to(dt).float()
        dc_next, f_next = dc, f[:, s]
    return steps(torch.stack(da, dim=1))


@pytest.mark.parametrize("shape", [(1, 2, 64), (9, 3, 64), (7, 2, 128)], ids=lambda s: "T{}-B{}-H{}".format(*s))
@pytest.mark.parametrize("kind", list(DTYPES))
def test_split_walk_replays_the_plain_walk(kind, shape):
    """The split route's arithmetic (phase A's coefficients, the cell
    update from them, the parts' sum order) against ``_bptt_reference``
    on the same inputs: da within TOL of its largest entry."""
    dtype = DTYPES[kind]
    proj, w_hh, cot = _inputs(sum(shape) + 1, *shape, dtype)
    out = lstm_sweep.lstm_sweep_reference(proj, w_hh)
    pre = lstm_sweep._recurrent_products(lstm_sweep._prev_hidden(out), w_hh.to(dtype).float())
    want = lstm_sweep._bptt_reference(proj, pre, cot, w_hh)
    got = _split_walk(proj, pre, cot, w_hh)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()


def test_segmentation_train_step_through_the_sweep_function_matches_jax(monkeypatch):
    """A 2-layer, H=16 PyanNet: three PIT-BCE AdamW steps with every sweep's
    gradient from SweepFunction's walk back through time (never autograd
    through the plain step loop), against diart_tpu's jitted steps from the
    same weights, under ``test_train_step_matches_jax``'s bounds."""
    kw = dict(num_speakers=3, lstm_hidden=16, lstm_layers=2, linear_dims=(8,))
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=4000, **kw)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=_tree(jseg.params), **kw)
    rng = np.random.default_rng(1)
    waves = rng.normal(scale=0.1, size=(2, 1, 4000)).astype(np.float32)
    apply_fn = jseg.apply_fn()
    frames = jax.eval_shape(apply_fn, jseg.params, jnp.asarray(waves)).shape[1]
    targets = (rng.uniform(size=(2, frames, 3)) > 0.6).astype(np.float32)
    jw, jt = jnp.asarray(waves), jnp.asarray(targets)
    jstate, tx = jax_make_train_state(jseg.params, learning_rate=1e-3)
    jstep = jax.jit(lambda s: (*jax_train_step(apply_fn, tx, s, jw, jt),
                               jax.grad(lambda p: jax_pit_bce_loss(apply_fn(p, jw), jt))(s.params)))
    walks, plain = [], lstm_sweep.lstm_sweep_backward_reference
    monkeypatch.setattr(lstm_sweep, "lstm_sweep_backward_reference", lambda *a: walks.append(1) or plain(*a))
    forward = lstm_sweep.lstm_sweep_reference

    def no_autograd_through(*args):
        assert not torch.is_grad_enabled(), "autograd through the plain step loop"
        return forward(*args)

    monkeypatch.setattr(lstm_sweep, "lstm_sweep_reference", no_autograd_through)
    state, opt = make_train_state(pseg, learning_rate=1e-3)
    w, t = _t(waves, targets)
    _check_against_jax(
        pseg.module, state, lambda s: train_step(lambda m, x: m(x), opt, s, w, t),
        jstate, jstep, lambda g: _flat(pseg.module, g), lambda js: _flat(pseg.module, js.params))
    assert len(walks) == 2 * 3  # two layers, three steps
