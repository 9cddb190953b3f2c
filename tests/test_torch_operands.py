"""The one rule that holds a kernel's prepared operands
(``diart_tpu_torch.models.common.held_operands``) at every site that holds
some, and the one convention of the seven kernel wrappers that take them
(``operands=``), on the CPU.

A holding case builds a small model, runs the site's forward and spies on
``held_operands`` in the site's module. The operands are made once; made
again after an in-place update of one of the site's parameters, a
``load_state_dict`` and a move to ``meta``; and bypassed (None) in a call
that trains any one of the site's parameters, which then gets its gradient
through the raw path, whose output is the held path's bit for bit. On
``meta`` the spy stops the forward where the site asks for its operands,
before any operation that has no route there.

A refusal case hands a wrapper operands that hold a tensor which requires a
gradient: refused under grad mode, taken without it, equal to the raw call.
"""

from types import ModuleType
from typing import Callable, NamedTuple, Optional

import pytest
import torch
from torch import nn

from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel
from diart_tpu_torch import precision
from diart_tpu_torch.models import common, ecapa, embedding, lstm, resnet, sincnet
from diart_tpu_torch.models.common import QuantizableConv, held_operands
from diart_tpu_torch.models.ecapa import EcapaTDNN
from diart_tpu_torch.models.embedding import XVectorSincNet
from diart_tpu_torch.models.lstm import BiLSTM
from diart_tpu_torch.models.resnet import ResNet34
from diart_tpu_torch.models.sincnet import SincNet
from diart_tpu_torch.models.titanet import TitaNet
from diart_tpu_torch.models.xvect import XVectorFbank
from diart_tpu_torch.ops import attn_stats, linear_stats, lstm_sweep, quant, se_res2
from diart_tpu_torch.ops import resnet_conv as rc
from diart_tpu_torch.ops import sinc_frontend as sf
from diart_tpu_torch.ops._grad import wants_grad
from diart_tpu_torch.parallel import engine as engine_module

INT8 = precision.Precision(int8_trunk=True)
STACKED = precision.Precision(stack_frontend=True)


class _Stop(Exception):
    """Raised by the spy where a stopped forward asks for its operands."""

    def __init__(self, operands):
        super().__init__()
        self.operands = operands


class Spy:
    """Stands in for ``held_operands`` in a site's module: counts the
    operands made and keeps each call's parameters and result."""

    def __init__(self):
        self.made = 0
        self.calls = []  # (params, operands or None)
        self.stop = False

    def __call__(self, owner, tag, params, make):
        params = tuple(params)

        def counted():
            self.made += 1
            return make()

        operands = held_operands(owner, tag, params, counted)
        if self.stop:
            raise _Stop(operands)
        self.calls.append((params, operands))
        return operands

    def operands(self):
        """The results of the calls since the last :meth:`clear`."""
        return [ops for _, ops in self.calls]

    def clear(self):
        self.calls.clear()


def _filled(module: nn.Module, seed: int) -> nn.Module:
    """Every parameter from ``seed``: the sinc cutoffs moved about their
    mel-spaced start, variances positive, the rest small."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith(("low_hz", "band_hz")):
                p.add_(20.0 * noise)
            elif name.endswith("var"):
                p.copy_(0.5 + noise.abs())
            else:
                p.copy_(0.2 * noise)
    return module


def _randn(*shape, seed=0, device="cpu", dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device=device, dtype=dtype)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _head_inputs(model, channels, time=23, speakers=3):
    dev = _device(model)
    return _randn(2, time, channels, seed=1, device=dev), _randn(2, speakers, time, seed=2, device=dev).sigmoid()


def _ecapa(seed):
    return _filled(EcapaTDNN(embedding_dim=8, channels=16, num_mels=20, attention_bottleneck=8, res2_scale=4,
                             se_bottleneck=8), seed)


def _resnet(seed):
    return _filled(ResNet34(embedding_dim=16, base_channels=8, depths=(1, 1, 1, 1), num_mels=16,
                            compute_dtype=torch.bfloat16), seed)


def _stacked(seed):
    """The stacked frontend's two SincNets (the engine's segmentation's and
    embedding's, the latter filled from ``seed``) as one module, with the
    engine beside them."""
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, num_speakers=3, lstm_hidden=8,
                                          lstm_layers=1, linear_dims=(8,))
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=4, embedding_dim=16)
    _filled(emb.module.sincnet, seed)
    engine = MultiStreamEngine(seg, emb, precision=STACKED, batch_size=1, duration=0.5, step=0.25, latency=0.5,
                               sample_rate=16000, max_speakers=4)
    assert engine._stacked is not None
    pair = nn.ModuleList(engine._stacked)
    pair.engine = engine
    return pair


def _run_stacked(pair):
    seg_pooled, emb_pooled = pair.engine._stacked_frontend(_randn(1, 1, 8000, seed=5, device=_device(pair)))
    return torch.cat([seg_pooled, emb_pooled], dim=1)


def _channels_last_anywhere(monkeypatch):
    """ResNet34's channels-last route on any device (the kernel's wrappers
    run their plain version on a CPU tensor), still never where a
    parameter trains."""
    monkeypatch.setattr(ResNet34, "channels_last",
                        lambda self, feats: self.compute_dtype == torch.bfloat16 and not wants_grad(*self.parameters()))


class Case(NamedTuple):
    module: ModuleType  # where the site calls held_operands
    build: Callable[[int], nn.Module]  # seed -> model
    run: Callable[[nn.Module], torch.Tensor]  # the site's forward, on the model's device
    params: Callable[[nn.Module], list]  # the site's parameters
    policy: Optional[precision.Precision] = None
    setup: Optional[Callable] = None  # (monkeypatch) -> None


def _head_params(model):
    return [*model.tdnn2.parameters(), *model.tdnn2_norm.parameters()]


CASES = {
    "xvector_sincnet.head": Case(
        embedding, lambda s: _filled(XVectorSincNet(embedding_dim=16, tdnn_specs=((5, 1, 32), (3, 2, 32),
                                                                                  (1, 1, 48))), s),
        lambda m: m.head(*_head_inputs(m, 32)), _head_params),
    "xvector_fbank.head": Case(
        embedding, lambda s: _filled(XVectorFbank(embedding_dim=16, tdnn_specs=((5, 1, 32), (3, 2, 32),
                                                                                (1, 1, 48))), s),
        lambda m: m.head(*_head_inputs(m, 32)), _head_params),
    "ecapa.scores": Case(common, _ecapa, lambda m: m.head(*_head_inputs(m, 48)), lambda m: list(m.att2.parameters())),
    "titanet.scores": Case(
        common, lambda s: _filled(TitaNet(embedding_dim=8, channels=16, mega_kernels=(3,), repeat=1, num_mels=20,
                                          attention_bottleneck=8), s),
        lambda m: m.head(*_head_inputs(m, 48)), lambda m: list(m.att2.parameters())),
    "ecapa.se_res2_block": Case(
        ecapa, lambda s: _ecapa(s).block1, lambda m: m(_randn(2, 19, 16, seed=3, device=_device(m))),
        lambda m: list(m.parameters())),
    "bilstm.w_hh": Case(
        lstm, lambda s: _filled(BiLSTM(12, 16, 2), s), lambda m: m(_randn(7, 2, 12, seed=4, device=_device(m))),
        lambda m: [m.l0_w_hh, m.l1_w_hh]),
    "sincnet.sinc_frontend": Case(
        sincnet, lambda s: _filled(SincNet(), s), lambda m: m(_randn(1, 1, 4000, seed=5, device=_device(m))),
        lambda m: [m.sinc.low_hz, m.sinc.band_hz]),
    "int8_conv.1d": Case(
        common, lambda s: _filled(QuantizableConv(8, 16, 3, dilation=2), s),
        lambda m: m(_randn(2, 8, 30, seed=6, device=_device(m))), lambda m: [m.weight, m.bias], INT8),
    "int8_conv.2d": Case(
        common, lambda s: _filled(QuantizableConv(8, 16, (3, 3), padding=1, bias=False), s),
        lambda m: m(_randn(2, 8, 9, 7, seed=7, device=_device(m))), lambda m: [m.weight], INT8),
    "resnet34.block": Case(
        resnet, lambda s: _resnet(s).layer2_0,
        lambda m: m.forward_channels_last(_randn(2, 9, 8, 8, seed=8, device=_device(m), dtype=torch.bfloat16)),
        lambda m: list(m.parameters())),
    "resnet34.stem": Case(
        resnet, _resnet, lambda m: m.trunk_from_features(_randn(2, 11, 16, seed=9, device=_device(m))),
        lambda m: [*m.conv1.parameters(), *m.bn1.parameters()], setup=_channels_last_anywhere),
    "engine.stacked_frontend": Case(
        engine_module, _stacked, _run_stacked,
        lambda m: [m[i].get_parameter(n) for i in (0, 1)
                   for n in ("sinc.low_hz", "sinc.band_hz", "wav_norm_scale", "wav_norm_bias")], STACKED),
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_held_operands_follow_their_parameters(name, monkeypatch):
    case = CASES[name]
    spy = Spy()
    monkeypatch.setattr(case.module, "held_operands", spy)
    if case.setup is not None:
        case.setup(monkeypatch)
    with precision.use(case.policy or precision.Precision(), force=True):
        model = case.build(0)
        with torch.no_grad():
            # made once: the second call takes the first call's operands
            want = case.run(model)
            first, made = spy.operands(), spy.made
            assert first and made == len(first) and all(ops is not None for ops in first)
            spy.clear()
            assert torch.equal(case.run(model), want)
            assert spy.made == made and all(a is b for a, b in zip(spy.operands(), first))
            # made again after an in-place update of one of the site's parameters, for
            # the calls that hold it only
            p = case.params(model)[0]
            p.mul_(1.5)
            spy.clear()
            assert not torch.equal(case.run(model), want)
            updated = [any(q is p for q in params) for params, _ in spy.calls]
            assert any(updated) and spy.made == made + sum(updated)
            assert all((ops is not old) == u for (_, ops), old, u in zip(spy.calls, first, updated))
            # ... and after a load
            made = spy.made
            model.load_state_dict(case.build(1).state_dict())
            spy.clear()
            want = case.run(model)
            assert spy.made == made + len(first) and not any(a is b for a, b in zip(spy.operands(), first))
        # bypassed wherever one of the site's parameters trains, which then gets its gradient
        cotangent = _randn(*want.shape, seed=10)
        for p in case.params(model):
            model.requires_grad_(False)
            p.requires_grad_(True)
            made = spy.made
            spy.clear()
            got = case.run(model)
            assert spy.made == made
            assert all(ops is None for params, ops in spy.calls if any(q is p for q in params))
            assert torch.equal(got.detach(), want)
            (got.float() * cotangent).sum().backward()
            assert p.grad is not None and p.grad.abs().sum() > 0
            p.grad = None
        # made again after a move
        model.requires_grad_(False)
        meta = model.to("meta")
        made, spy.stop = spy.made, True
        with torch.no_grad(), pytest.raises(_Stop) as stop:
            case.run(meta)
    assert spy.made == made + 1
    tensors = [t for t in stop.value.operands if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)


def test_the_store_stays_out_of_the_state():
    """The one store is a plain attribute: no state-dict entry, parameter or
    buffer comes of it."""
    model = CASES["ecapa.scores"].build(0)
    names = (set(model.state_dict()), {n for n, _ in model.named_parameters()},
             {n for n, _ in model.named_buffers()})
    with torch.no_grad():
        model.head(*_head_inputs(model, 48))
    assert "_held_operands" in vars(model.att2)
    assert names == (set(model.state_dict()), {n for n, _ in model.named_parameters()},
                     {n for n, _ in model.named_buffers()})


# ----------------------------------------------------------------------- #
# every wrapper refuses operands that require a gradient


def _lstm_refusal():
    w_hh, proj = _randn(2, 32, 8, seed=11).requires_grad_(), _randn(4, 2, 1, 32, seed=12)
    return (lambda: lstm_sweep.lstm_sweep_tm(proj, operands=lstm_sweep.pack_w_hh(w_hh, torch.float32)),
            lambda: lstm_sweep.lstm_sweep_tm(proj, w_hh.detach()))


def _stats_refusal():
    x, weights = _randn(2, 9, 16, seed=13), _randn(2, 3, 9, seed=14).sigmoid()
    w, b = _randn(16, 24, seed=15).requires_grad_(), _randn(24, seed=16)
    return (lambda: linear_stats.fused_linear_stats(
                x, weights=weights, operands=linear_stats.prepare_stats_operands(w, b, b, b, x.dtype)),
            lambda: linear_stats.fused_linear_stats(x, w.detach(), b, b, b, weights))


def _attn_refusal():
    x, hidden, weights = _randn(2, 9, 24, seed=17), _randn(2, 9, 16, seed=18), _randn(2, 3, 9, seed=19).sigmoid()
    w2, b2 = _randn(16, 24, seed=20).requires_grad_(), _randn(24, seed=21)
    return (lambda: attn_stats.fused_attentive_stats(x, hidden, weights=weights,
                                                     operands=attn_stats.prepare_attn_operands(w2, b2)),
            lambda: attn_stats.fused_attentive_stats(x, hidden, w2.detach(), b2, weights))


def _se_res2_refusal():
    block = _ecapa(22).block1
    params = [p.detach() for p in block.folded_params()]
    params[0].requires_grad_(True)
    x = _randn(1, 12, 16, seed=23)
    with pytest.raises(TypeError, match="diagnostic"):  # the stage mode has no gradient at all
        se_res2.se_res2_staged(x, params, 2, 1)
    with torch.no_grad():
        assert se_res2.se_res2_staged(x, params, 2, 1).shape == x.shape
    return (lambda: se_res2.fused_se_res2_block(x, None, 2, operands=se_res2.kernel_operands(params, x.dtype)),
            lambda: se_res2.fused_se_res2_block(x, [p.detach() for p in params], 2))


def _sinc_refusal():
    bank, x = SincNet().sinc.filters().detach(), _randn(1, 1, 4000, seed=24)
    trained = bank.clone().requires_grad_()
    return (lambda: sf.sinc_frontend(x, None, 10, operands=sf.prepare_sinc_operands(trained)),
            lambda: sf.sinc_frontend(x, bank, 10))


def _resnet_refusal():
    x, w = _randn(1, 5, 4, 8, seed=25, dtype=torch.bfloat16), _randn(16, 8, 3, 3, seed=26)
    a, b = _randn(16, seed=27), _randn(16, seed=28)
    ops = rc.prepare_conv_operands(w, a, b)
    ops = ops._replace(shift=ops.shift.clone().requires_grad_())
    return (lambda: rc.resnet_conv(x, w, padding=1, dtype=torch.bfloat16, operands=ops),
            lambda: rc.resnet_conv(x, w, a, b, padding=1, dtype=torch.bfloat16))


def _int8_refusal():
    x, w, b = _randn(2, 8, 12, seed=29), _randn(16, 8, 3, seed=30), _randn(16, seed=31).requires_grad_()
    return (lambda: quant.int8_conv(x, w, b, operands=quant.prepare_int8_operands(w, b)),
            lambda: quant.int8_conv(x, w, b.detach()))


REFUSALS = {
    "lstm_sweep_tm": _lstm_refusal,
    "fused_linear_stats": _stats_refusal,
    "fused_attentive_stats": _attn_refusal,
    "fused_se_res2_block": _se_res2_refusal,
    "sinc_frontend": _sinc_refusal,
    "resnet_conv": _resnet_refusal,
    "int8_conv": _int8_refusal,
}


@pytest.mark.parametrize("wrapper", sorted(REFUSALS))
def test_prepared_operands_that_require_grad_are_refused(wrapper):
    held, raw = REFUSALS[wrapper]()
    with pytest.raises(TypeError, match="require a gradient"):
        held()
    with torch.no_grad():  # made as held operands are: taken
        got, want = held(), raw()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(map(torch.equal, got, want))
