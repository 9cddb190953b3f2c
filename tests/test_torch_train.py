"""Parity of the port's training layer (``diart_tpu_torch.train`` and the
kernels' gradients) with diart_tpu's, on the CPU.

The same numpy inputs go through both packages: the losses against
``diart_tpu.train``'s; each kernel's ``autograd.Function`` (on CPU tensors
its forward is the plain version, its backward autograd through the plain
version, as on the card) against ``jax.grad`` through the ``diart_tpu``
wrapper in Pallas interpret mode; the trainers' steps against JAX's jitted
steps from the same weights (the flax init carried over by
``load_flax_params``). Then the port's own checkpoints and the trained
models' held kernel operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diart_tpu.precision as jax_precision
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.ops.pallas_attn_stats import fused_attentive_stats as jax_attn_stats
from diart_tpu.ops.pallas_lstm import lstm_sweep_tm as jax_lstm_sweep_tm
from diart_tpu.ops.pallas_res2 import fused_se_res2_block as jax_se_res2
from diart_tpu.ops.pallas_stats import fused_linear_stats as jax_linear_stats
from diart_tpu.train import aam_softmax_loss as jax_aam_softmax_loss
from diart_tpu.train import embedding_train_step as jax_embedding_train_step
from diart_tpu.train import make_embedding_train_state as jax_make_embedding_train_state
from diart_tpu.train import make_train_state as jax_make_train_state
from diart_tpu.train import pit_bce_loss as jax_pit_bce_loss
from diart_tpu.train import train_step as jax_train_step
from diart_tpu_torch.models import EmbeddingModel, SegmentationModel
from diart_tpu_torch.models.ecapa import _SERes2Block
from diart_tpu_torch.ops import attn_stats, linear_stats, lstm_sweep, se_res2
from diart_tpu_torch.train import (
    aam_softmax_loss,
    embedding_train_step,
    latest_checkpoint,
    make_embedding_train_state,
    make_train_state,
    pit_bce_loss,
    restore_train_state,
    save_train_state,
    train_step,
)
from diart_tpu_torch.weights import _flatten

from test_torch_families import jax_registry

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
XVEC_KW = dict(embedding_dim=16)
ECAPA_KW = dict(embedding_dim=16, channels=64)
LR = 1e-3
STEPS = 3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(module, tree) -> dict:
    """A flax tree (parameters or their gradients) by the port's parameter
    names, in the port's layouts."""
    tree = _tree(tree)
    out = {}
    _flatten(module, tree["params"] if set(tree) == {"params"} else tree, "", out)
    return out


def _t(*arrays, grad=False):
    return [torch.tensor(np.asarray(a), requires_grad=grad) for a in arrays]


# ----------------------------------------------------------------------- #
# losses


# rtol 1e-6: the same f32 formulas on both sides (a log and two einsums
# over frames, the permutation score, a min and a mean).
@pytest.mark.parametrize("k", [2, 3, 4])
def test_pit_bce_loss_matches_jax(k):
    rng = np.random.default_rng(k)
    pred = rng.uniform(0.01, 0.99, (3, 40, k)).astype(np.float32)
    target = (rng.uniform(size=(3, 40, k)) > 0.5).astype(np.float32)
    want = float(jax_pit_bce_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = pit_bce_loss(*_t(pred, target))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the gradient picks the same permutation on both sides
    gp = jax.grad(lambda p: jax_pit_bce_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    pit_bce_loss(p, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), rtol=1e-5, atol=1e-9)


def test_pit_bce_loss_permutation_invariance():
    rng = np.random.default_rng(42)
    pred, target = _t(rng.uniform(0.01, 0.99, (2, 30, 3)).astype(np.float32),
                      (rng.uniform(size=(2, 30, 3)) > 0.5).astype(np.float32))
    base = float(pit_bce_loss(pred, target))
    assert float(pit_bce_loss(pred, target[..., [2, 0, 1]])) == pytest.approx(base, rel=1e-6)
    assert float(pit_bce_loss(pred[..., [1, 2, 0]], target)) == pytest.approx(base, rel=1e-6)


# rtol 1e-6: the same f32 formulas; margin 1.2 puts some targets past
# pi - m, on the hard-example branch.
@pytest.mark.parametrize("margin", [0.0, 0.2, 1.2])
def test_aam_softmax_loss_matches_jax(margin):
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(12, 16)).astype(np.float32)
    protos = rng.normal(size=(5, 16)).astype(np.float32)
    labels = rng.integers(0, 5, size=12)
    want = float(jax_aam_softmax_loss(jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(protos),
                                      margin=margin))
    got = aam_softmax_loss(*_t(emb, labels, protos), margin=margin)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if margin > 1.0:
        cos = (emb / np.linalg.norm(emb, axis=1, keepdims=True)) @ (
            protos / np.linalg.norm(protos, axis=1, keepdims=True)).T
        assert (cos[np.arange(12), labels] <= np.cos(np.pi - margin)).any()


def test_aam_margin_penalizes_target():
    rng = np.random.default_rng(42)
    emb, protos = _t(rng.normal(size=(4, 16)).astype(np.float32), rng.normal(size=(8, 16)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    plain = float(aam_softmax_loss(emb, labels, protos, margin=0.0))
    assert float(aam_softmax_loss(emb, labels, protos, margin=0.3)) > plain


# ----------------------------------------------------------------------- #
# the kernels' Functions: gradients against jax.grad through the Pallas
# wrappers (interpret mode), whose custom_vjp differentiates the reference


def _grads_match(fn_port, fn_jax, inputs, cotangents, rtol, atol):
    """The port's Function backward and jax.grad of ``sum(cot * out)``."""
    port_in = _t(*inputs, grad=True)
    outs = fn_port(*port_in)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    torch.autograd.backward(outs, _t(*cotangents))

    def loss(*args):
        res = fn_jax(*args)
        res = res if isinstance(res, tuple) else (res,)
        return sum(jnp.sum(r.astype(jnp.float32) * c) for r, c in zip(res, cotangents))

    want = jax.grad(loss, argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))
    # the floor is relative to the largest gradient of any input: some are
    # zero but for rounding (the softmax over frames ignores b2)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (p, w) in enumerate(zip(port_in, want)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=rtol, atol=atol * scale,
                                   err_msg=f"input {i}")
    return port_in


def _cotangents(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# f32: the same reference formulation differentiated on both sides; sums
# in another order: rtol 1e-4 with a floor of 1e-5 of the largest gradient
# of any input.
def test_sweep_function_grad_matches_jax():
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(9, 2, 2, 32)).astype(np.float32)
    w_hh = rng.normal(scale=0.3, size=(2, 32, 8)).astype(np.float32)
    cot = _cotangents(rng, (9, 2, 2, 8))
    got = _grads_match(lambda p, w: lstm_sweep.SweepFunction.apply(p, w, None),
                       lambda p, w: jax_lstm_sweep_tm(p, w, interpret=True, block=0),
                       (proj, w_hh), cot, 1e-4, 1e-5)
    # the wrapper's CPU route (autograd through the plain version) gives the same bits
    p, w = _t(proj, w_hh, grad=True)
    lstm_sweep.lstm_sweep_tm(p, w).backward(torch.from_numpy(cot[0]))
    assert torch.equal(p.grad, got[0].grad) and torch.equal(w.grad, got[1].grad)


def test_linear_stats_function_grad_matches_jax():
    rng = np.random.default_rng(1)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    x, w, b = f(2, 13, 16), f(16, 24, scale=0.2), f(24, scale=0.1)
    scale, shift = 1.0 + f(24, scale=0.1), f(24, scale=0.1)
    weights = rng.uniform(size=(2, 3, 13)).astype(np.float32)
    cot = _cotangents(rng, (2, 3, 24), (2, 3, 24))
    _grads_match(lambda *a: linear_stats.LinearStatsFunction.apply(*a, None, 0.01),
                 lambda *a: jax_linear_stats(*a, interpret=True),
                 (x, w, b, scale, shift, weights), cot, 1e-4, 1e-5)


def test_attn_stats_function_grad_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    hidden = np.tanh(rng.normal(size=(2, 11, 8))).astype(np.float32)
    w2 = (0.3 * rng.normal(size=(8, 24))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    weights = rng.uniform(size=(2, 3, 11)).astype(np.float32)
    cot = _cotangents(rng, (2, 3, 24), (2, 3, 24), (2, 3, 24))
    _grads_match(lambda *a: attn_stats.AttnStatsFunction.apply(*a, None),
                 lambda *a: jax_attn_stats(*a, interpret=True),
                 (x, hidden, w2, b2, weights), cot, 1e-4, 1e-5)


def _res2_params(rng, chans, scale, taps=3, hidden=16):
    """Unit-gain block parameters (the regime of tests/test_pallas_res2.py)."""
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


def test_se_res2_function_grad_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 17, 32)).astype(np.float32)
    params = _res2_params(rng, 32, 4)
    cot = _cotangents(rng, (2, 17, 32))
    _grads_match(lambda x, *p: se_res2.SERes2Function.apply(x, *p, None, 2),
                 lambda x, *p: jax_se_res2(x, p, 2, interpret=True),
                 (x, *params), cot, 1e-4, 1e-5)


# bf16 streams: the Function's backward is the plain version's autograd,
# so it gives the bits of autograd through the plain version itself.
def test_functions_bf16_backward_is_the_plain_autograd():
    rng = np.random.default_rng(4)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)
    cases = [
        (lstm_sweep.SweepFunction.apply, lstm_sweep.lstm_sweep_reference,
         [bf(rng.normal(size=(7, 2, 2, 32))), torch.tensor(0.3 * rng.normal(size=(2, 32, 8)), dtype=torch.float32)], (None,)),
        (linear_stats.LinearStatsFunction.apply, linear_stats.linear_stats_reference,
         [bf(rng.normal(size=(2, 9, 16))), *_t(*(0.2 * rng.normal(size=s) for s in ((16, 24), (24,), (24,), (24,)))),
          torch.rand(2, 3, 9)], (None, 0.01)),
    ]
    for fn, ref, inputs, extra in cases:
        inputs = [t.float().to(t.dtype).requires_grad_(True) for t in inputs]
        out = fn(*inputs, *extra)
        out = out if isinstance(out, tuple) else (out,)
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(5)).to(o.dtype) for o in out]
        got = torch.autograd.grad(out, inputs, cots)
        want_out = ref(*inputs, *extra[1:])
        want_out = want_out if isinstance(want_out, tuple) else (want_out,)
        want = torch.autograd.grad(want_out, inputs, cots)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_prepared_operands_that_require_grad_are_refused():
    w_hh = torch.randn(2, 32, 8, requires_grad=True)
    proj = torch.randn(4, 2, 1, 32)
    with pytest.raises(TypeError, match="require a gradient"):
        lstm_sweep.lstm_sweep_tm(proj, lstm_sweep.pack_w_hh(w_hh, torch.float32))
    with torch.no_grad():  # made as held operands are: accepted
        packed = lstm_sweep.pack_w_hh(w_hh, torch.float32)
    assert torch.equal(lstm_sweep.lstm_sweep_tm(proj, packed), lstm_sweep.lstm_sweep_tm(proj, w_hh.detach()))
    w, b = torch.randn(16, 24, requires_grad=True), torch.randn(24)
    x, weights = torch.randn(2, 9, 16), torch.rand(2, 3, 9)
    with pytest.raises(TypeError, match="StatsOperands"):
        linear_stats.fused_linear_stats(x, linear_stats.prepare_stats_operands(w, b, b, b, x.dtype), weights=weights)
    with pytest.raises(TypeError, match="AttnOperands"):
        attn_stats.fused_attentive_stats(torch.randn(2, 9, 24), torch.randn(2, 9, 16),
                                         attn_stats.prepare_attn_operands(w, b), weights=weights)
    params = [torch.from_numpy(p) for p in _res2_params(np.random.default_rng(0), 32, 4)]
    params[0].requires_grad_(True)
    xr = torch.randn(1, 12, 32)
    with pytest.raises(TypeError, match="Res2Operands"):
        se_res2.fused_se_res2_block(xr, se_res2.kernel_operands(params, xr.dtype), 2)
    with pytest.raises(TypeError, match="diagnostic"):
        se_res2.se_res2_staged(xr, params, 2, 1)
    with torch.no_grad():
        assert se_res2.se_res2_staged(xr, params, 2, 1).shape == xr.shape


# ----------------------------------------------------------------------- #
# F1: every SE-Res2Block parameter gets its gradient


@pytest.fixture(scope="module")
def ecapa_models():
    jemb = jax_registry(JaxEmbeddingModel, "tpu/ecapa", init_samples=4800, **ECAPA_KW)
    pemb = EmbeddingModel.from_registry("tpu/ecapa", device="cpu", flax_params=_tree(jemb.params), **ECAPA_KW)
    return jemb, pemb


# f32 on both sides (JAX's unfused block on the CPU, the port's plain
# version of the fused one): every block parameter's gradient within rtol
# 1e-3 and 1e-4 of its largest entry (sums in another order through three
# blocks, the MFA and the attentive head).
def test_se_res2_block_parameters_get_jax_gradients(ecapa_models):
    jemb, pemb = ecapa_models
    rng = np.random.default_rng(11)
    wave = rng.normal(scale=0.1, size=(2, 1, 4800)).astype(np.float32)
    cot = rng.normal(size=(2, ECAPA_KW["embedding_dim"])).astype(np.float32)
    module = pemb.module
    module.requires_grad_(True)
    try:
        module.zero_grad(set_to_none=True)
        (module(torch.from_numpy(wave)) * torch.from_numpy(cot)).sum().backward()
        grads = {n: p.grad for n, p in module.named_parameters()}
    finally:
        module.requires_grad_(False)
    jmod = jemb.module
    want = _flat(module, jax.jit(jax.grad(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(wave)) * cot)))(jemb.params))
    blocks = [n for n in grads if n.startswith("block")]
    assert blocks and all(isinstance(m, _SERes2Block) for m in (module.block1, module.block2, module.block3))
    for name in blocks:
        assert grads[name] is not None, f"{name} got no gradient"
        w = want[name]
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


# ----------------------------------------------------------------------- #
# the trainers against JAX's jitted steps


def _check_against_jax(module, state, step_port, jax_state, jax_step, flat_grads, params_of):
    """Losses, first-step gradients and parameters, STEPS steps each side.

    First loss: rtol 1e-5 (f32 sums in another order through the whole
    model). Gradients, tensor by tensor, norm-wise within 1e-2: a leaky
    ReLU input within rounding of 0 takes the other slope on the other
    side, so a few entries below it differ by up to 99%; a tensor whose
    gradient is zero but for rounding (a bias before a normalization), with
    a norm under 1e-6 of the largest, within 1e-6 of the largest entry.
    Parameters: Adam's step is lr * m / (sqrt(v) + eps); where |g| is near
    eps (1e-8) it magnifies rounding noise to up to lr in either direction,
    so an entry may differ by up to 2 * lr a step: after STEPS steps every
    entry within 2 * lr * STEPS. After the first step, the entries whose
    gradient is at least 1e-3 of their tensor's largest (and above the
    rounding floor) moved lr * g / (|g| + eps) on both sides: within
    1e-2 * lr and 1e-6 of the value, but for one in a thousand (an entry
    below a flipped slope may change sign). The later losses follow the
    parameters: rtol 1e-3.
    """
    named = lambda s: [*module.named_parameters(), *(
        [("prototypes", s.prototypes)] if s.prototypes is not None else [])]
    losses_p, losses_j = [], []
    for i in range(STEPS):
        state, loss = step_port(state)
        jax_state, jloss, jgrads = jax_step(jax_state)
        if i == 0:
            first = {n: p.grad.clone() for n, p in named(state)}
            one_step = {n: p.detach().clone().numpy() for n, p in named(state)}
            jax_grads, jax_one_step = flat_grads(jgrads), params_of(jax_state)
        losses_p.append(float(loss))
        losses_j.append(float(jloss))
    np.testing.assert_allclose(losses_p[0], losses_j[0], rtol=1e-5)
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-3)
    assert state.step == STEPS and int(jax_state.step) == STEPS
    largest = max(np.abs(w).max() for w in jax_grads.values())
    norms = {n: np.linalg.norm(w) for n, w in jax_grads.items()}
    top = max(norms.values())
    for name, w in jax_grads.items():
        diff = first[name].numpy() - w
        if norms[name] >= 1e-6 * top:
            assert np.linalg.norm(diff) <= 1e-2 * norms[name], (name, np.linalg.norm(diff) / norms[name])
        else:
            assert np.abs(diff).max() <= 1e-6 * largest, name
        sure = (np.abs(w) >= 1e-3 * np.abs(w).max()) & (np.abs(w) >= 1e-6 * largest)
        off = np.abs(one_step[name] - jax_one_step[name]) > 1e-2 * LR + 1e-6 * np.abs(jax_one_step[name])
        assert (off & sure).sum() <= 1e-3 * sure.sum(), (name, (off & sure).sum(), sure.sum())
    after = params_of(jax_state)
    for name, p in named(state):
        assert np.abs(p.detach().numpy() - after[name]).max() <= 2 * LR * STEPS, name
    return state


def test_train_step_matches_jax():
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=4000, **SEG_KW)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=_tree(jseg.params), **SEG_KW)
    rng = np.random.default_rng(0)
    waves = rng.normal(scale=0.1, size=(3, 1, 4000)).astype(np.float32)
    apply_fn = jseg.apply_fn()
    frames = jax.eval_shape(apply_fn, jseg.params, jnp.asarray(waves)).shape[1]
    targets = (rng.uniform(size=(3, frames, 3)) > 0.6).astype(np.float32)
    jw, jt = jnp.asarray(waves), jnp.asarray(targets)
    jstate, tx = jax_make_train_state(jseg.params, learning_rate=LR)
    # JAX's jitted step, with the gradients at the parameters it starts from
    jstep = jax.jit(lambda s: (*jax_train_step(apply_fn, tx, s, jw, jt),
                               jax.grad(lambda p: jax_pit_bce_loss(apply_fn(p, jw), jt))(s.params)))
    assert all(not p.requires_grad for p in pseg.module.parameters())  # from_registry freezes
    state, opt = make_train_state(pseg, learning_rate=LR)
    assert state.module is pseg.module and all(p.requires_grad for p in state.module.parameters())
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(pseg.module.parameters()))
    w, t = _t(waves, targets)
    state = _check_against_jax(
        pseg.module, state, lambda s: train_step(lambda m, x: m(x), opt, s, w, t),
        jstate, jstep, lambda g: _flat(pseg.module, g), lambda js: _flat(pseg.module, js.params))
    # the held w_hh layout follows the update: a no-grad forward of the
    # trained module equals a fresh module loaded with its weights
    fresh = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=5, **SEG_KW)
    fresh.module.load_state_dict(state.module.state_dict())
    with torch.no_grad():
        assert torch.equal(state.module(w), fresh.module(w))


@pytest.mark.parametrize("family", ["xvector", "ecapa"])
def test_embedding_train_step_matches_jax(family, request, monkeypatch):
    """The port pools through its kernels' plain versions (moments, then
    mean and std), so JAX runs its Pallas kernels too (interpret mode, whose
    backward is that plain version): the unfused heads' two-pass std rounds
    otherwise, which the std's 1 / (2 std) magnifies. Tones under noise of
    a third of their amplitude, so no channel's variance is near zero."""
    kw = XVEC_KW if family == "xvector" else ECAPA_KW
    fused = {"pallas_head"} if family == "xvector" else {"pallas_attn", "pallas_res2"}
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f in fused)
    samples = 8000 if family == "xvector" else 4800
    if family == "ecapa":
        jemb, _ = request.getfixturevalue("ecapa_models")
    else:
        jemb = jax_registry(JaxEmbeddingModel, "tpu/xvector", init_samples=samples, **kw)
    pemb = EmbeddingModel.from_registry(f"tpu/{family}", device="cpu", flax_params=_tree(jemb.params), **kw)
    rng = np.random.default_rng(1)
    t = np.arange(samples) / 16000.0
    labels = np.arange(6) % 3
    waves = np.stack([0.3 * np.sin(2 * np.pi * (400.0 + 500.0 * l) * t) + 0.1 * rng.normal(size=samples)
                      for l in labels]).astype(np.float32)[:, None, :]
    jmod = jemb.module
    embed_fn = lambda p, x: jmod.apply(p, x)
    jw, jl = jnp.asarray(waves), jnp.asarray(labels)
    jstate, tx = jax_make_embedding_train_state(jemb.params, 3, kw["embedding_dim"], learning_rate=LR, seed=2)
    loss_fn = lambda p: jax_aam_softmax_loss(embed_fn(p["model"], jw), jl, p["prototypes"])
    jstep = jax.jit(lambda s: (*jax_embedding_train_step(embed_fn, tx, s, jw, jl), jax.grad(loss_fn)(s.params)))
    state, opt = make_embedding_train_state(pemb, 3, kw["embedding_dim"], learning_rate=LR, seed=2)
    assert state.prototypes.shape == (3, kw["embedding_dim"])
    with torch.no_grad():
        state.prototypes.copy_(torch.from_numpy(np.asarray(jstate.params["prototypes"])))
    module = pemb.module
    flat = lambda tree: {**_flat(module, tree["model"]), "prototypes": np.asarray(tree["prototypes"])}
    w, l = _t(waves, labels)
    state = _check_against_jax(
        module, state, lambda s: embedding_train_step(lambda m, x: m(x), opt, s, w, l),
        jstate, jstep, flat, lambda js: flat(js.params))
    # held kernel operands (the x-vector's stats head, ECAPA's blocks and
    # attention scores) are remade after the optimizer's in-place updates
    fresh = EmbeddingModel.from_registry(f"tpu/{family}", device="cpu", seed=5, **kw)
    fresh.module.load_state_dict(module.state_dict())
    with torch.no_grad():
        assert torch.equal(module(w), fresh.module(w))


def test_prototypes_are_seeded():
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=0, **XVEC_KW)
    a, _ = make_embedding_train_state(pemb, 4, 16, seed=3)
    b, _ = make_embedding_train_state(pemb, 4, 16, seed=3)
    c, _ = make_embedding_train_state(pemb, 4, 16, seed=4)
    assert torch.equal(a.prototypes, b.prototypes) and not torch.equal(a.prototypes, c.prototypes)
    assert isinstance(a.prototypes, torch.nn.Parameter)


# ----------------------------------------------------------------------- #
# checkpoints


def _small_seg(seed=0):
    return SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=seed, **SEG_KW)


def _seg_batch():
    rng = np.random.default_rng(3)
    waves = torch.from_numpy(rng.normal(scale=0.1, size=(2, 1, 4000)).astype(np.float32))
    frames = _small_seg().num_frames(4000)
    targets = torch.from_numpy((rng.uniform(size=(2, frames, 3)) > 0.6).astype(np.float32))
    return waves, targets


def test_checkpoint_roundtrip(tmp_path):
    state, _ = make_train_state(_small_seg(0))
    state = state._replace(step=7)
    save_train_state(tmp_path, state)
    assert latest_checkpoint(tmp_path).name == "step_00000007.pt"
    fresh, _ = make_train_state(_small_seg(1))
    restored = restore_train_state(tmp_path, fresh)
    assert restored.step == 7
    for (n, a), (_, b) in zip(state.module.state_dict().items(), restored.module.state_dict().items()):
        assert torch.equal(a, b), n


def test_checkpoint_pruning(tmp_path):
    state, _ = make_train_state(_small_seg())
    for step in range(5):
        save_train_state(tmp_path, state._replace(step=step), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*.pt")) == ["step_00000003.pt", "step_00000004.pt"]
    # a rollback: writing an older step keeps it, whatever the pruning
    save_train_state(tmp_path, state._replace(step=1), keep=2)
    assert (tmp_path / "step_00000001.pt").exists()
    assert latest_checkpoint(tmp_path).name == "step_00000001.pt"


def test_latest_checkpoint_falls_back_without_a_valid_marker(tmp_path):
    assert latest_checkpoint(tmp_path) is None
    state, _ = make_train_state(_small_seg())
    for step in (2, 5):
        save_train_state(tmp_path, state._replace(step=step))
    (tmp_path / "latest.json").unlink()
    assert latest_checkpoint(tmp_path).name == "step_00000005.pt"
    (tmp_path / "latest.json").write_text('{"step": 9}')  # names a file that is gone
    assert latest_checkpoint(tmp_path).name == "step_00000005.pt"
    (tmp_path / "latest.json").write_text("not json")
    assert latest_checkpoint(tmp_path).name == "step_00000005.pt"
    (tmp_path / "latest.json").write_text('{"step": 2}')
    assert latest_checkpoint(tmp_path).name == "step_00000002.pt"
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "empty", state)


@pytest.mark.parametrize("family", ["segmentation", "xvector"])
def test_resume_is_bitwise(tmp_path, family):
    """2 steps, save, restore into a fresh state, 2 more: the bits of 4
    straight steps (model, optimizer moments and prototypes)."""
    if family == "segmentation":
        waves, targets = _seg_batch()
        model = lambda seed: _small_seg(seed)
        make = lambda m: make_train_state(m, learning_rate=LR)
        step = lambda opt, s: train_step(lambda m, x: m(x), opt, s, waves, targets)
    else:
        rng = np.random.default_rng(4)
        waves = torch.from_numpy(rng.normal(scale=0.1, size=(4, 1, 8000)).astype(np.float32))
        labels = torch.tensor([0, 1, 0, 1])
        model = lambda seed: EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=seed, **XVEC_KW)
        make = lambda m: make_embedding_train_state(m, 2, 16, learning_rate=LR, seed=1)
        step = lambda opt, s: embedding_train_step(lambda m, x: m(x), opt, s, waves, labels)

    straight, opt = make(model(0))
    losses = []
    for _ in range(4):
        straight, loss = step(opt, straight)
        losses.append(loss)
    resumed, opt2 = make(model(0))
    for _ in range(2):
        resumed, _ = step(opt2, resumed)
    save_train_state(tmp_path, resumed)
    again, opt3 = make(model(9))  # other weights and fresh moments, overwritten by the restore
    again = restore_train_state(tmp_path, again)
    assert again.step == 2
    tail = []
    for _ in range(2):
        again, loss = step(opt3, again)
        tail.append(loss)
    assert again.step == 4
    assert all(torch.equal(a, b) for a, b in zip(tail, losses[2:]))
    for (n, a), b in zip(straight.module.state_dict().items(), again.module.state_dict().values()):
        assert torch.equal(a, b), n
    if straight.prototypes is not None:
        assert torch.equal(straight.prototypes, again.prototypes)
    for a, b in zip(opt.state.values(), opt3.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
