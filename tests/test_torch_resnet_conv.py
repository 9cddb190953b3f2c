"""ResNet34's trunk convolutions in one launch each (``ops/resnet_conv.py``,
``csrc/resnet_conv.cu``), on the CPU: the plain version against the
composition ``models/resnet.py`` ran before it (bitwise, bf16 and f32), the
kernel's weight layout and tiling replayed in float64, the refusals of its
wrapper, and the model's route: channels-last launches only on a card in
bf16 with the int8 trunk off and nothing trained; everything else today's
NCHW code, with no launch.

On the card: ``python3 chip_smoke.py --kernels resnet`` (every distinct
geometry of the trunk at B = 256 against the plain version, timed), and
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_resnet_conv_card.py``."""

import types
import zlib

import pytest
import torch
import torch.nn.functional as F

from diart_tpu_torch import precision
from diart_tpu_torch.models.common import InferenceBatchNorm, QuantizableConv
from diart_tpu_torch.models.resnet import ResNet34
from diart_tpu_torch.ops import resnet_conv as rc

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (name, C_in as a multiple of the width, C_out as one, window, stride,
# padding, residual, ReLU): the trunk's kinds of convolution
KINDS = (
    ("stem", 0, 1, 3, 1, 1, False, True),
    ("3x3.s1", 1, 1, 3, 1, 1, False, True),
    ("3x3.s1.res", 1, 1, 3, 1, 1, True, True),
    ("3x3.s1.res.norelu", 1, 1, 3, 1, 1, True, False),
    ("3x3.s1.norelu", 1, 1, 3, 1, 1, False, False),
    ("3x3.s2", 1, 2, 3, 2, 1, False, True),
    ("3x3.s2.res", 1, 2, 3, 2, 1, True, True),
    ("1x1.s2.down", 1, 2, 1, 2, 0, False, False),
    ("1x1.s2.relu", 1, 2, 1, 2, 0, False, True),
)


def _norm(c_out, gen):
    bn = InferenceBatchNorm(c_out)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.3 * torch.randn(c_out, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c_out, generator=gen))
        bn.mean.copy_(0.3 * torch.randn(c_out, generator=gen))
        bn.var.copy_(0.5 + torch.rand(c_out, generator=gen))
    return bn


def _case(kind, width, dtype, gen, batch=2, t=11, f=9):
    _, m_in, m_out, k, stride, pad, has_res, relu = kind
    c_in, c_out = max(1, m_in * width), m_out * width
    conv = QuantizableConv(c_in, c_out, (k, k), compute_dtype=dtype, bias=False, stride=stride, padding=pad,
                           quantizable=c_in > 1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(c_out, c_in, k, k, generator=gen) / (c_in * k * k) ** 0.5)
    bn = _norm(c_out, gen)
    x = torch.randn(batch, t, f, c_in, generator=gen)
    x = x if c_in == 1 else x.to(dtype)  # the stem reads the f32 features
    o1, o2 = (t + 2 * pad - k) // stride + 1, (f + 2 * pad - k) // stride + 1
    res = torch.randn(batch, o1, o2, c_out, generator=gen).to(dtype) if has_res else None
    return conv, bn, x, res, relu


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_plain_version_is_the_composition(kind, width, dt):
    """The plain version on channels-last x equals, bit for bit, the
    composition the model runs on NCHW tensors: QuantizableConv ->
    InferenceBatchNorm (-> + residual) (-> ReLU)."""
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(zlib.crc32(f"{kind[0]}.{width}.{dt}".encode()))
    conv, bn, x, res, relu = _case(kind, width, dtype, gen)
    with torch.no_grad():
        nchw = x.to(dtype).permute(0, 3, 1, 2).contiguous()
        want = bn(conv(nchw))
        if res is not None:
            want = want + res.permute(0, 3, 1, 2).contiguous()
        if relu:
            want = torch.relu(want)
        a, b = bn.folded()
        got = rc.resnet_conv(x, conv.weight, a, b, conv.stride, conv.padding, res, relu, dtype=dtype)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want.permute(0, 2, 3, 1)), (got - want.permute(0, 2, 3, 1)).abs().max()


def _replay(x, ops: rc.ConvOperands, stride, pad, plan: rc.ConvPlan):
    """The kernel's sums in float64, tile by tile as its plan cuts the
    output: a block's 2 ms boxes of box1 x box2 positions, each tap's box
    of the activations (zeros past the edges and past C_in) against that
    tap's weight rows."""
    batch, t, f, c_in = x.shape
    c_out = ops.rows.shape[0]
    (k1, k2), c_pad = ops.kernel, plan.c_pad
    o1, o2 = (t + 2 * pad - k1) // stride + 1, (f + 2 * pad - k2) // stride + 1
    rows = plan.rows
    w = ops.rows.double().view(c_out, k1 * k2, c_pad)
    xp = torch.zeros(batch, t + 2 * pad + rows * stride * 2, f + 2 * pad + plan.box2 * stride * 2,
                     c_pad, dtype=torch.float64)
    xp[:, pad:pad + t, pad:pad + f, :c_in] = x.double()
    out = torch.zeros(batch, plan.tiles[1] * rows, plan.tiles[2] * plan.box2, c_out, dtype=torch.float64)
    for n in range(plan.tiles[0]):
        cols = slice(n * plan.n, min(c_out, (n + 1) * plan.n))
        for q1 in range(0, plan.tiles[1] * rows, plan.box1):  # a box
            for q2 in range(0, plan.tiles[2] * plan.box2, plan.box2):
                acc = torch.zeros(batch, plan.box1 * plan.box2, cols.stop - cols.start, dtype=torch.float64)
                for tap in range(k1 * k2):
                    i, j = divmod(tap, k2)
                    box = xp[:, q1 * stride + i: (q1 + plan.box1) * stride + i: stride,
                             q2 * stride + j: (q2 + plan.box2) * stride + j: stride]
                    acc += box.reshape(batch, -1, c_pad) @ w[cols, tap].T
                out[:, q1:q1 + plan.box1, q2:q2 + plan.box2, cols] = acc.view(batch, plan.box1, plan.box2, -1)
    return out[:, :o1, :o2]


@pytest.mark.parametrize("c_in,c_out,k,stride,t,f", [
    (8, 8, 3, 1, 13, 10), (8, 16, 3, 2, 13, 10), (8, 16, 1, 2, 13, 10), (24, 40, 3, 1, 7, 11),
    (32, 64, 3, 2, 17, 12), (64, 320, 3, 2, 9, 7), (32, 32, 3, 1, 21, 80),
])
def test_layout_and_plan_replay_the_convolution(c_in, c_out, k, stride, t, f):
    """The weight rows (taps x C_pad, zero past C_in) and the launch plan's
    tiles, replayed in float64, give conv2d of the bf16 operands exactly;
    the plan covers every output position and channel, and its boxes fit
    the tensor memory accelerator's 256-element traversal."""
    gen = torch.Generator().manual_seed(c_in * 1000 + c_out)
    pad = k // 2
    x = torch.randn(2, t, f, c_in, generator=gen).to(torch.bfloat16)
    weight = torch.randn(c_out, c_in, k, k, generator=gen)
    ops = rc.prepare_conv_operands(weight, torch.ones(c_out), torch.zeros(c_out))
    o1, o2 = (t + 2 * pad - k) // stride + 1, (f + 2 * pad - k) // stride + 1
    plan = rc.conv_plan(c_out, o1, o2, c_in, (k, k), (stride, stride), (pad, pad))
    halo = k == 3 and stride == 1
    assert plan.route == ("taps" if not halo else "pingpong" if plan.c_pad == plan.bk and plan.n <= 64 else "halo")
    assert plan.ms == ((4 if plan.n <= 32 else 2 if plan.n <= 128 else 1) if halo else 1)
    assert ops.rows.shape == (c_out, k * k * plan.c_pad) and ops.rows.dtype == torch.bfloat16
    assert plan.c_pad % 16 == 0 and plan.c_pad % plan.bk == 0 and plan.c_pad >= c_in
    assert plan.box1 * plan.box2 == rc.ROWS and plan.n in rc.TILE_N
    rows = plan.rows
    assert rows == (1 if plan.route == "pingpong" else 2) * plan.ms * plan.box1
    if halo:
        assert rows + 2 <= rc.BOX_MAX and plan.box2 + 2 <= rc.BOX_MAX
    else:
        assert plan.box1 * stride <= rc.BOX_MAX and plan.box2 * stride <= rc.BOX_MAX
    assert plan.tiles[0] * plan.n >= c_out and plan.tiles[1] * rows >= o1
    assert plan.tiles[2] * plan.box2 >= o2
    want = F.conv2d(x.double().permute(0, 3, 1, 2), weight.to(torch.bfloat16).double(), stride=stride, padding=pad)
    assert torch.equal(_replay(x, ops, stride, pad, plan), want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("geometry,want", [
    ((32, 498, 80, 32), (32, 4, 16, 32, 32, (1, 32, 5), "pingpong", 4)),
    ((64, 249, 40, 64), (64, 8, 8, 64, 64, (1, 16, 5), "pingpong", 2)),
    ((128, 125, 20, 128), (128, 16, 4, 64, 128, (1, 2, 5), "halo", 2)),
    ((256, 63, 10, 256), (256, 32, 2, 64, 256, (1, 1, 5), "halo", 1)),
    ((64, 249, 40, 32, (3, 3), (2, 2), (1, 1)), (64, 8, 8, 32, 32, (1, 16, 5), "taps", 1)),
    ((128, 125, 20, 64, (1, 1), (2, 2), (0, 0)), (128, 16, 4, 64, 64, (1, 4, 5), "taps", 1)),
    ((256, 63, 10, 128, (3, 3), (2, 2), (1, 1)), (256, 32, 2, 64, 128, (1, 1, 5), "taps", 1)),
    ((8, 37, 20, 8), (16, 2, 32, 16, 16, (1, 5, 1), "pingpong", 4)),
])
def test_plan_at_the_trunks_geometries(geometry, want):
    """At the published trunk's maps the boxes divide the mel axis, so a
    tile wastes positions only along time."""
    assert tuple(rc.conv_plan(*geometry)) == want


def test_operands_round_as_the_plain_version():
    """The held weights and norm are bf16 values of the raw parameters; the
    stem's weights are (C_out, 9) f32 holding them."""
    gen = torch.Generator().manual_seed(5)
    w, a, b = torch.randn(16, 1, 3, 3, generator=gen), torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    ops = rc.prepare_conv_operands(w, a, b)
    assert ops.rows.dtype == torch.float32 and ops.rows.shape == (16, 9) and ops.kernel == (3, 3)
    assert torch.equal(ops.rows, w.to(torch.bfloat16).float().view(16, 9))
    assert ops.scale.dtype == ops.shift.dtype == torch.bfloat16
    assert torch.equal(ops.scale, a.to(torch.bfloat16)) and torch.equal(ops.shift, b.to(torch.bfloat16))
    w8 = torch.randn(8, 8, 3, 3, generator=gen)
    rows = rc.prepare_conv_operands(w8, a[:8], b[:8]).rows.view(8, 3, 3, 16)
    assert torch.equal(rows[..., :8], w8.to(torch.bfloat16).permute(0, 2, 3, 1))
    assert not rows[..., 8:].any()


def _refusal(x, weight, stride=(1, 1), padding=(1, 1), residual=None, dtype=torch.bfloat16):
    ops = rc.prepare_conv_operands(weight, torch.ones(weight.shape[0]), torch.zeros(weight.shape[0]))
    return rc._refuse(x, weight, ops, stride, padding, residual, dtype)


def test_kernel_refusals():
    """What the wrapper raises on for a CUDA tensor (its rules, checked on
    CPU tensors): f32 or f16 activations (f32 only for the one-channel
    stem), an f32 compute dtype, channels not a multiple of 8, activations
    that are not a contiguous (B, T, F, C) tensor, a strided residual, a
    gradient, another convolution's operands, a stem that is not 3x3 /
    stride 1 / padding 1. What it takes is refused by none."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 8, 16, generator=gen).to(torch.bfloat16)
    w = torch.randn(16, 16, 3, 3, generator=gen)
    assert _refusal(x, w) is None
    assert _refusal(torch.randn(2, 9, 8, 1), torch.randn(8, 1, 3, 3)) is None  # the stem from f32 features
    assert "bfloat16 activations" in _refusal(x.float(), w)
    assert "bfloat16 activations" in _refusal(x.half(), w)
    assert "computes in bfloat16 only" in _refusal(x, w, dtype=torch.float32)
    x12 = torch.randn(2, 9, 8, 12).to(torch.bfloat16)
    assert "multiples of 8" in _refusal(x12, torch.randn(16, 12, 3, 3))
    assert "multiples of 8" in _refusal(x, torch.randn(12, 16, 3, 3))
    strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert "channels-last" in _refusal(strided, w)
    res = torch.zeros(2, 9, 16, 8, dtype=torch.bfloat16).transpose(2, 3)
    assert "residual" in _refusal(x, w, residual=res)
    assert "backward" in _refusal(x, w.clone().requires_grad_())
    ops = rc.prepare_conv_operands(torch.randn(32, 16, 3, 3), torch.ones(32), torch.zeros(32))
    assert "operands" in rc._refuse(x, w, ops, (1, 1), (1, 1), None, torch.bfloat16)
    assert "stem" in _refusal(torch.randn(2, 9, 8, 1), torch.randn(8, 1, 3, 3), stride=(2, 2))


def test_wrapper_checks_shapes():
    """On any device: x and the weight's channels, the residual's shape and
    a window larger than the padded input raise; the CPU call needs the
    folded norm."""
    x = torch.randn(1, 5, 4, 8)
    w = torch.randn(8, 8, 3, 3)
    one = torch.ones(8)
    with pytest.raises(ValueError, match="input channels"):
        rc.resnet_conv(x, torch.randn(8, 16, 3, 3), one, one, padding=1)
    with pytest.raises(ValueError, match="residual"):
        rc.resnet_conv(x, w, one, one, padding=1, residual=torch.zeros(1, 5, 4, 16))
    with pytest.raises(ValueError, match="smaller than the window"):
        rc.resnet_conv(torch.randn(1, 2, 2, 8), w, one, one)
    with pytest.raises(ValueError, match="scale and shift"):
        rc.resnet_conv(x, w, padding=1)


def _model(dtype, base=8, seed=0):
    torch.manual_seed(seed)
    model = ResNet34(embedding_dim=16, base_channels=base, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("var"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            else:
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return model


def _card_feats(feats):
    """A stand-in for features on a card (what the route reads of them)."""
    return types.SimpleNamespace(is_cuda=True, device=torch.device("cuda"))


def test_route_chooser():
    """Channels-last launches only for a card, bf16, widths that are
    multiples of 8, the int8 trunk off and no parameter trained; f32,
    int8_trunk, training, other widths and CPU tensors take today's code."""
    card = _card_feats(None)
    cpu = torch.zeros(1, 4, 80)
    bf16, f32, narrow = _model(torch.bfloat16), _model(torch.float32), _model(torch.bfloat16, base=4)
    with torch.no_grad():
        assert bf16.channels_last(card)
        assert not f32.channels_last(card)
        assert not narrow.channels_last(card)
        assert not bf16.channels_last(cpu)
        with precision.use(precision.Precision(int8_trunk=True), force=True):
            assert not bf16.channels_last(card)
    assert not bf16.channels_last(card)  # grad mode on and parameters that require a gradient: training
    for p in bf16.parameters():
        p.requires_grad_(False)
    assert bf16.channels_last(card)


@pytest.mark.parametrize("route", ["bf16", "f32", "int8_trunk", "trained"])
def test_other_routes_are_todays_code(route):
    """On the CPU (and on a card for f32, the int8 trunk or training) the
    trunk is today's NCHW composition, block by block, bit for bit, and
    the kernel's wrapper is never called."""
    dtype = torch.float32 if route == "f32" else torch.bfloat16
    model = _model(dtype, seed=7)
    feats = torch.randn(2, 23, 80, generator=torch.Generator().manual_seed(1))
    policy = precision.Precision(int8_trunk=route == "int8_trunk")
    before = rc.resnet_conv.launches
    with precision.use(policy, force=True), torch.set_grad_enabled(route == "trained"):
        got = model.trunk_from_features(feats)
        x = torch.relu(model.bn1(model.conv1(feats.to(dtype)[:, None])))
        for name in model.blocks:
            block = getattr(model, name)
            y = torch.relu(block.bn1(block.conv1(x)))
            y = block.bn2(block.conv2(y))
            res = block.downsample_bn(block.downsample_conv(x)) if block.downsample else x
            x = torch.relu(y + res)
        b, c, t, f = x.shape
        want = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    assert rc.resnet_conv.launches == before
    assert torch.equal(got, want)
    assert got.requires_grad == (route == "trained")


def test_channels_last_blocks_equal_the_composition():
    """The model's channels-last route (``forward_channels_last`` with each
    convolution's operands held), run here through the plain version,
    gives the NCHW route's trunk bit for bit, in bf16 and f32; the held
    operands are made once and remade after a parameter changes."""
    for dtype in (torch.bfloat16, torch.float32):
        model = _model(dtype, seed=11)
        feats = torch.randn(2, 19, 80, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            x = feats.to(dtype)[:, None]
            x = torch.relu(model.bn1(model.conv1(x))).permute(0, 2, 3, 1).contiguous()
            for name in model.blocks:
                block = getattr(model, name)
                x = _blocks_plain(block, x)
            b, t, f, c = x.shape
            got = x.transpose(2, 3).reshape(b, t, c * f)
            want = model.trunk_from_features(feats)
        assert torch.equal(got, want)


def _blocks_plain(block, x):
    """``forward_channels_last`` with the plain version standing in for the
    launches (the CPU's route for a (B, T, F, C) tensor)."""
    def conv(c, bn, inp, residual=None, relu=True):
        a, b = bn.folded()
        return rc.resnet_conv(inp, c.weight, a, b, c.stride, c.padding, residual, relu, dtype=c.compute_dtype)

    y = conv(block.conv1, block.bn1, x)
    res = conv(block.downsample_conv, block.downsample_bn, x, relu=False) if block.downsample else x
    return conv(block.conv2, block.bn2, y, residual=res)


def _swizzled(offset: int, row_bytes: int) -> int:
    """The tensor memory accelerator's swizzle of a byte offset in a tile of
    ``row_bytes`` rows (128, 64 or 32 bytes; the tile 1024-byte aligned):
    the 16-byte chunk bits [4, 4 + b) XOR the bits [7, 7 + b) above them,
    b = log2(row_bytes / 16)."""
    b = (row_bytes // 16).bit_length() - 1
    mask = (1 << b) - 1
    return offset ^ (((offset >> 7) & mask) << 4)


@pytest.mark.parametrize("c_in,c_out,t,f", [(32, 32, 21, 80), (64, 64, 19, 40), (128, 128, 9, 20),
                                            (256, 256, 7, 10), (8, 8, 13, 20)])
def test_halo_addresses_replay_each_tap(c_in, c_out, t, f):
    """The halo routes' ldmatrix addresses (``resnet_conv_halo``,
    ``resnet_conv_pingpong``: a lane's
    row h0 + (i hw + j) of the halo, its 16-byte chunk 2 ks + lane / 16
    XOR the swizzle's row bits) read, from a halo laid out as the tensor
    memory accelerator lays one out (rows of positions, the border as
    zeros, swizzled), the 8 channels of the input that tap (i, j) of the
    lane's output position needs, for every lane, box, tap and K slice of
    the first and the last tile."""
    import numpy as np

    plan = rc.conv_plan(c_out, t, f, c_in)
    assert plan.route in ("halo", "pingpong")
    row = 2 * plan.bk
    rows, hw = plan.rows, plan.box2 + 2
    # the halo route's tile is both warpgroups' (warpgroup wg's boxes after
    # wg ms of them); the ping-pong route's is one warpgroup's
    groups = (0,) if plan.route == "pingpong" else (0, 1)
    x = np.arange(t * f * plan.c_pad, dtype=np.int64).reshape(t, f, plan.c_pad) + 1
    x[..., c_in:] = 0  # channels past C_in: the tensor map's out-of-bounds zeros
    for o1, o2 in ((0, 0), ((plan.tiles[1] - 1) * rows, (plan.tiles[2] - 1) * plan.box2)):
        for s in range(plan.c_pad // plan.bk):
            halo = np.zeros((rows + 2) * hw * row // 2, dtype=np.int64)  # bf16 elements
            for hr in range(rows + 2):
                for hc in range(hw):
                    p1, p2 = o1 - 1 + hr, o2 - 1 + hc
                    if 0 <= p1 < t and 0 <= p2 < f:
                        for ch in range(plan.bk):
                            at = _swizzled((hr * hw + hc) * row + 2 * ch, row)
                            halo[at // 2] = x[p1, p2, s * plan.bk + ch]
            swz = row // 16 - 1
            for wg in groups:
                for wq in range(4):
                    for lane in range(32):
                        m = wq * 16 + (lane & 15)
                        mr, mc = divmod(m, plan.box2)
                        for ms in range(plan.ms):
                            h0 = ((wg * plan.ms + ms) * plan.box1 + mr) * hw + mc
                            q1, q2 = o1 + (wg * plan.ms + ms) * plan.box1 + mr, o2 + mc
                            for tap in range(9):
                                i, j = divmod(tap, 3)
                                h = h0 + i * hw + j
                                for ks in range(plan.bk // 16):
                                    q = 2 * ks + (lane >> 4)
                                    at = h * row + ((q ^ ((h * row >> 7) & swz)) << 4)
                                    got = halo[at // 2: at // 2 + 8]
                                    p1, p2 = q1 + i - 1, q2 + j - 1
                                    c0 = s * plan.bk + 8 * q
                                    want = (x[p1, p2, c0:c0 + 8] if 0 <= p1 < t and 0 <= p2 < f
                                            else np.zeros(8, dtype=np.int64))
                                    assert (got == want).all(), (wg, wq, lane, ms, tap, ks)
