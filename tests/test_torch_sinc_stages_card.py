"""SincNet's second and third stages on the card (``csrc/sinc_stages.cu``):
the kernels against the plain version at B = 1, 7, 64 and 256, at 5 s
windows and a shorter length, for f32 and bf16 products; bitwise over two
calls and with torch's TF32 switches flipped; the model's route from the
first stage's kernel and the stacked frontend's halves; the gradient of the
``autograd.Function``. Skipped without a card.

This file imports neither JAX nor the JAX package, and ``tests/conftest.py``
imports JAX, so on the card it runs without the conftest:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_sinc_stages_card.py``."""

import pytest
import torch

from diart_tpu_torch import precision
from diart_tpu_torch.models.sincnet import SincNet
from diart_tpu_torch.ops import sinc_frontend as sf
from diart_tpu_torch.ops import sinc_stages as ss

pytestmark = pytest.mark.card

# The tolerances, of the output's largest magnitude (chip_smoke.py
# STAGES_TOL). f32: 3xTF32 products summed in another order than cuDNN's true
# f32, a few f32 roundings of each convolution's output, which the norms carry
# through. bf16: both round each convolution's output to bf16, and a last-bit
# difference of the f32 sum flips such a rounding now and then: one bf16 step
# (at most 2^-7 of the value), which norm3 scales by up to |y| / std.
TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0**-5}
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card; decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _net(dtype, seed=0):
    """A SincNet on the card with its stages' parameters moved off their init."""
    net = SincNet(compute_dtype=dtype).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(("norm", "conv")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    net.requires_grad_(False)
    return net


def _args(net):
    norms = tuple(getattr(net, f"norm{i}_{k}") for i in (1, 2, 3) for k in ("scale", "bias"))
    convs = (net.conv2.weight, net.conv2.bias, net.conv3.weight, net.conv3.bias)
    return norms, convs, ss.prepare_stage_operands(*convs, net.compute_dtype)


def _held(got, want, dtype):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert got.shape == want.shape and err <= TOL[dtype] * scale, (err, TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("p1", [2658, 1001])
@pytest.mark.parametrize("batch", [1, 7, 64, 256])
def test_kernels_hold_the_plain_version(card, batch, p1, dtype):
    net = _net(dtype)
    norms, convs, ops = _args(net)
    gen = torch.Generator(device="cuda").manual_seed(batch)
    pooled = torch.randn(batch, 80, p1, generator=gen, device="cuda").abs()
    before = ss.sinc_stages.launches
    got = ss.sinc_stages(pooled, norms, None, None, None, None, dtype, operands=ops)
    assert ss.sinc_stages.launches == before + 1
    _held(got, ss.sinc_stages_reference(pooled, norms, *convs, dtype), dtype)
    assert torch.equal(ss.sinc_stages(pooled, norms, None, None, None, None, dtype, operands=ops), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_bitwise_across_the_tf32_switches(card, dtype):
    net = _net(dtype)
    norms, _, ops = _args(net)
    pooled = torch.rand(64, 80, 2658, device="cuda")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        outs = []
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
            outs.append(ss.sinc_stages(pooled, norms, None, None, None, None, dtype, operands=ops))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(*outs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_model_from_the_first_stage(card, dtype):
    """SincNet's forward on a waveform: the first stage's kernel hands its
    pooled output to the stages' kernels."""
    net = _net(dtype)
    norms, convs, _ = _args(net)
    wave = torch.randn(16, 1, 80000, device="cuda")
    with precision.use(precision.Precision(bf16_frontend=True), force=True):
        got = net(wave)
        z = ss.instance_norm(wave, net.wav_norm_scale, net.wav_norm_bias)
        pooled = sf.sinc_frontend(z, net.sinc.filters(), net.sinc.stride)
    _held(got, ss.sinc_stages_reference(pooled, norms, *convs, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_stacked_frontends_halves(card, dtype):
    """The engine's stacked frontend: each half of the (B, 160, P1) pooled
    output, a view a stream apart of 160 rows, bitwise its copy."""
    seg, emb = _net(dtype, seed=1), _net(dtype, seed=2)
    wave = torch.randn(9, 1, 80000, device="cuda")
    bank = torch.cat([seg.sinc.filters(), emb.sinc.filters()])
    with precision.use(precision.Precision(bf16_frontend=True), force=True):
        pooled = sf.sinc_frontend(wave, bank, 10, banks=2)
    for net, half in ((seg, pooled[:, :80]), (emb, pooled[:, 80:])):
        assert not half.is_contiguous()
        got = net(None, pooled=half)
        assert torch.equal(got, net(None, pooled=half.contiguous()))
        norms, convs, _ = _args(net)
        _held(got, ss.sinc_stages_reference(half, norms, *convs, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_function_trains(card, dtype):
    """Under autograd the kernels run forward and the plain version's
    gradient runs backward, on the raw inputs the call saved: the gradients
    are bitwise autograd's through the plain version for the same cotangent."""
    net = _net(dtype)
    net.requires_grad_(True)
    norms = tuple(getattr(net, f"norm{i}_{k}") for i in (1, 2, 3) for k in ("scale", "bias"))
    convs = (net.conv2.weight, net.conv2.bias, net.conv3.weight, net.conv3.bias)
    pooled = torch.rand(4, 80, 1001, device="cuda", requires_grad=True)
    leaves = (pooled, *norms, *convs)
    before = ss.sinc_stages.launches
    got = ss.sinc_stages(pooled, norms, *convs, dtype)
    assert ss.sinc_stages.launches == before + 1
    cotangent = torch.randn(got.shape, device="cuda")
    grads = torch.autograd.grad((got * cotangent).sum(), leaves)
    want = ss.sinc_stages_reference(pooled, norms, *convs, dtype)
    _held(got.detach(), want.detach(), dtype)
    for g, w in zip(grads, torch.autograd.grad((want * cotangent).sum(), leaves)):
        assert torch.equal(g, w)
