"""ResNet34's trunk convolutions on the card (``csrc/resnet_conv.cu``): every
distinct geometry of the trunk at published widths against the plain
version within the room of the summation order, the test family's widths,
the refusals and the model's channels-last route. Skipped without a card.

This file imports neither JAX nor the JAX package, and ``tests/conftest.py``
imports JAX, so on the card it runs without the conftest:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_resnet_conv_card.py``."""

import pytest
import torch

from diart_tpu_torch.models.common import InferenceBatchNorm
from diart_tpu_torch.ops import resnet_conv as rc

# (C_in, C_out, window, stride, T, F, residual, ReLU): the trunk's geometries
# (stem; stages 1-4's 3x3 at stride 1 with the residual; the 3x3 and 1x1
# downsamples at stride 2) at B = 16, and the test family's widths
GEOMETRIES = (
    (1, 32, 3, 1, 498, 80, False, True),
    (32, 32, 3, 1, 498, 80, True, True),
    (32, 32, 3, 1, 498, 80, False, True),
    (32, 64, 3, 2, 498, 80, False, True),
    (32, 64, 1, 2, 498, 80, False, False),
    (64, 64, 3, 1, 249, 40, True, True),
    (64, 128, 3, 2, 249, 40, False, True),
    (128, 128, 3, 1, 125, 20, True, True),
    (128, 256, 3, 2, 125, 20, False, True),
    (128, 256, 1, 2, 125, 20, False, False),
    (256, 256, 3, 1, 63, 10, True, True),
    (8, 8, 3, 1, 37, 20, True, True),
    (8, 16, 3, 2, 37, 20, False, True),
    (24, 40, 3, 1, 29, 77, True, False),
)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card; decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _case(geometry, batch, seed):
    c_in, c_out, k, stride, t, f, has_res, relu = geometry
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = n(batch, t, f, c_in)
    x = x if c_in == 1 else x.to(torch.bfloat16)
    weight = n(c_out, c_in, k, k) / (c_in * k * k) ** 0.5
    bn = InferenceBatchNorm(c_out).cuda()
    with torch.no_grad():
        bn.scale.copy_(1 + 0.1 * n(c_out))
        bn.bias.copy_(0.1 * n(c_out))
        bn.mean.copy_(0.1 * n(c_out))
        bn.var.copy_(0.5 + torch.rand(c_out, generator=gen, device="cuda"))
        a, b = bn.folded()
    pad = k // 2
    o1, o2 = (t + 2 * pad - k) // stride + 1, (f + 2 * pad - k) // stride + 1
    res = n(batch, o1, o2, c_out).to(torch.bfloat16) if has_res else None
    return x, weight, a, b, res, stride, pad, relu


def _room(x, weight, a, b, res, stride, pad):
    """Each output's room for the summation order alone (chip_smoke.py's
    ``resnet_allowance``): the f32 sums' own difference, at most 2 (K - 1)
    2^-24 of the sum of |products| times |a|, plus one bf16 step (2^-7) of
    each rounding point's value: |a c| twice, then bf16(a c) + b, then the
    value before ReLU."""
    import torch.nn.functional as F

    dt = torch.bfloat16
    k = weight.shape[1] * weight.shape[2] * weight.shape[3]
    xc = x.to(dt).permute(0, 3, 1, 2)
    c = F.conv2d(xc, weight.to(dt), stride=stride, padding=pad).float()
    mags = F.conv2d(xc.float().abs(), weight.to(dt).float().abs(), stride=stride, padding=pad)
    av, bv = a.to(dt).float().view(1, -1, 1, 1), b.to(dt).float().view(1, -1, 1, 1)
    y2 = ((c * av).to(dt).float() + bv).to(dt).float()
    y3 = y2 if res is None else (y2 + res.permute(0, 3, 1, 2).float()).to(dt).float()
    room = 2.0 * (k - 1) * 2.0**-24 * mags * av.abs() + 2.0**-7 * (2 * (av * c).abs() + y2.abs() + y3.abs())
    return room.permute(0, 2, 3, 1)


@pytest.mark.card
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "x".join(map(str, g[:6])))
def test_kernel_against_the_plain_version(card, geometry):
    """The kernel's output against the plain version on the card (cuDNN's
    bf16 convolution, then PyTorch's norm, add and ReLU) within the room of
    the summation order, element by element, and equal but for at most 0.1%
    of the elements; bitwise over two calls; one stream alone bitwise its
    row of the batch; one launch a call."""
    x, weight, a, b, res, stride, pad, relu = _case(geometry, 16, sum(geometry))
    ops = rc.prepare_conv_operands(weight, a, b)
    before = rc.resnet_conv.launches
    got = rc.resnet_conv(x, weight, a, b, stride, pad, res, relu, torch.bfloat16, operands=ops)
    assert rc.resnet_conv.launches == before + 1
    want = rc.resnet_conv_reference(x, weight, a, b, stride, pad, res, relu, torch.bfloat16)
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    err = (got.float() - want.float()).abs()
    room = _room(x, weight, a, b, res, stride, pad)
    assert (err <= room).all(), (err / room.clamp_min(1e-30)).max()
    # the summation order alone flips the rounding of few outputs; a rounding
    # step out of place (a product and a sum fused) moves 8-28% of them
    assert (err > 0).float().mean().item() <= 1e-3
    assert torch.equal(got, rc.resnet_conv(x, weight, a, b, stride, pad, res, relu, torch.bfloat16, operands=ops))
    alone = rc.resnet_conv(x[5:6], weight, a, b, stride, pad, None if res is None else res[5:6], relu,
                           torch.bfloat16, operands=ops)
    assert torch.equal(alone, got[5:6])


@pytest.mark.card
def test_kernel_refusals_on_the_card(card):
    """f32 activations, channels not a multiple of 8, activations that are
    not channels-last and a gradient raise on a CUDA tensor."""
    x, weight, a, b, _, _, _, _ = _case((16, 16, 3, 1, 9, 8, False, True), 2, 1)
    odd = _case((12, 16, 3, 1, 9, 8, False, True), 2, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        rc.resnet_conv(x.float(), weight, a, b, padding=1)
    with pytest.raises(ValueError, match="multiples of 8"):
        rc.resnet_conv(odd[0], odd[1], odd[2], odd[3], padding=1)
    with pytest.raises(ValueError, match="channels-last"):
        rc.resnet_conv(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), weight, a, b, padding=1)
    with pytest.raises(ValueError, match="backward"):
        rc.resnet_conv(x, weight.clone().requires_grad_(), a, b, padding=1)


@pytest.mark.card
def test_model_routes_on_the_card(card):
    """The bf16 model's trunk on the card: 36 launches, and the output
    within bf16 rounding of the composition it replaced (the NCHW route,
    forced); the f32 model launches nothing and is the composition's."""
    from diart_tpu_torch import precision
    from diart_tpu_torch.models.resnet import ResNet34

    torch.manual_seed(0)
    feats = torch.randn(4, 200, 80, device="cuda")
    feats = feats - feats.mean(dim=1, keepdim=True)
    for dtype in (torch.bfloat16, torch.float32):
        model = ResNet34(compute_dtype=dtype).cuda()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("var"):
                    p.uniform_(0.5, 1.5)
                elif name.endswith("scale"):
                    p.uniform_(0.5, 1.5)
                elif p.dim() > 1:
                    p.normal_(0, (1.0 / p[0].numel()) ** 0.5)
                else:
                    p.normal_(0, 0.1)
            before = rc.resnet_conv.launches
            got = model.trunk_from_features(feats)
            launched = rc.resnet_conv.launches - before
            model.channels_last = lambda f: False
            want = model.trunk_from_features(feats)
        assert launched == (36 if dtype == torch.bfloat16 else 0)
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            gap = (got.float() - want.float()).abs().max().item()
            assert gap <= 0.05 * want.float().abs().max().item(), gap
    with torch.no_grad(), precision.use(precision.Precision(int8_trunk=True), force=True):
        model = ResNet34(compute_dtype=torch.bfloat16).cuda()
        before = rc.resnet_conv.launches
        model.trunk_from_features(feats)
        assert rc.resnet_conv.launches == before
