"""SincNet's second and third stages (``ops/sinc_stages.py``,
``csrc/sinc_stages.cu``) held on the CPU: the op's CPU route is the
composition the model ran before (bitwise), the wrapper's refusals, the
held operands, the gradient of its ``autograd.Function``, the launch count,
and replays of what the kernels compute that plain PyTorch can state: the
prepared W^T (its k order, padding and hi / lo split) under the tiles'
index arithmetic (float64), the 3xTF32 products at SincNet's widths, the
norms' statistics merged from the tiles, and the launch plan. The kernels
themselves are held against the plain version on the card by
``tests/test_torch_sinc_stages_card.py`` and ``chip_smoke.py``
(``check_sinc_stages``).
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diart_tpu_torch.models import sincnet as sincnet_module
from diart_tpu_torch.models.sincnet import SincNet
from diart_tpu_torch.ops import _numerics
from diart_tpu_torch.ops import sinc_stages as ss

CSRC = Path(ss.__file__).resolve().parents[1] / "csrc" / "sinc_stages.cu"
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _net(seed=0, dtype=torch.float32):
    """A SincNet with every parameter of its stages moved off its init."""
    net = SincNet(compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(("norm", "conv")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return net


def _pooled(batch, p1, seed=1):
    """A first stage's output: |.| of noise, (B, 80, P1) f32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.abs(rng.normal(size=(batch, 80, p1))).astype(np.float32))


def _norms(net):
    return tuple(getattr(net, f"norm{i}_{k}") for i in (1, 2, 3) for k in ("scale", "bias"))


def _convs(net):
    return net.conv2.weight, net.conv2.bias, net.conv3.weight, net.conv3.bias


def _composition(net, pooled):
    """SincNet's stages as the model composed them before the op."""

    def norm(x, scale, bias):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + 1e-5) * scale[None, :, None] + bias[None, :, None]

    x = F.leaky_relu(norm(pooled, net.norm1_scale, net.norm1_bias), 0.01)
    cd = net.compute_dtype
    for i in (2, 3):
        conv = getattr(net, f"conv{i}")
        with _numerics.conv_scope(x.device, cd):
            x = F.conv1d(x.to(cd), conv.weight.to(cd), conv.bias.to(cd)).float()
        x = F.max_pool1d(x, 3)
        x = F.leaky_relu(norm(x, getattr(net, f"norm{i}_scale"), getattr(net, f"norm{i}_bias")), 0.01)
    return x


# P1 at 5 s (2658: conv2's pool drops 2 frames, conv3's 1), and two lengths
# whose pools drop frames at both stages
LENGTHS = (2658, 1001, 110)


@pytest.mark.parametrize("p1", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cpu_route_is_the_composition(p1, dtype):
    net, pooled = _net(dtype=dtype), _pooled(2, p1)
    p2, p3 = ss.frames(p1)
    assert (p1 - 4) % 3 and (p2 - 4) % 3  # both pools drop frames
    with torch.no_grad():
        got = net(None, pooled=pooled)
        want = _composition(net, pooled)
        direct = ss.sinc_stages(pooled, _norms(net), *_convs(net), dtype)
    assert got.shape == (2, 60, p3) and got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(direct, want)


def test_the_stacked_halves_take_the_same_route():
    """The engine's stacked frontend hands each model a half of (B, 160,
    P1): a view a stream apart of 160 rows, taken as it is."""
    net, both = _net(), _pooled(3, 300).repeat(1, 2, 1)
    half = both[:, 80:]
    assert not half.is_contiguous()
    with torch.no_grad():
        assert torch.equal(net(None, pooled=half), _composition(net, half.contiguous()))


def test_refusals():
    net, pooled = _net(), _pooled(2, 200)
    norms, convs = tuple(t.detach() for t in _norms(net)), tuple(t.detach() for t in _convs(net))
    ops = ss.prepare_stage_operands(*convs, torch.float32)
    with pytest.raises(ValueError, match="pooled must be"):
        ss.sinc_stages(pooled[:, :79], norms, *convs, torch.float32)
    with pytest.raises(ValueError, match="w2 must be"):
        ss.sinc_stages(pooled, norms, convs[0][:, :70], *convs[1:], torch.float32)
    with pytest.raises(ValueError, match="w3 must be"):
        ss.prepare_stage_operands(*convs[:2], convs[2][:50], convs[3], torch.float32)
    with pytest.raises(ValueError, match="norms are"):
        ss.sinc_stages(pooled, norms[:2] + norms[:4], *convs, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ss.sinc_stages(pooled.transpose(1, 2).contiguous().transpose(1, 2), norms, *convs, torch.float32)
    with pytest.raises(ValueError, match="another device"):
        meta = ss.prepare_stage_operands(*(t.to("meta") for t in convs), torch.float32)
        ss.sinc_stages(pooled, norms, None, None, None, None, torch.float32, operands=meta)
    with pytest.raises(ValueError, match="carry"):
        ss.sinc_stages(pooled, norms, *convs, torch.float32, operands=ops)
    with pytest.raises(ValueError, match="laid out for"):
        ss.sinc_stages(pooled, norms, None, None, None, None, torch.bfloat16, operands=ops)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ss.prepare_stage_operands(*convs, torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.sinc_stages(pooled.to("meta"), tuple(t.to("meta") for t in norms), *(t.to("meta") for t in convs),
                       torch.float32)
    # operands that require a gradient, where autograd records the call
    trained = ss.prepare_stage_operands(convs[0].detach().clone().requires_grad_(), *convs[1:], torch.float32)
    with pytest.raises(TypeError, match="require a gradient"):
        ss.sinc_stages(pooled.requires_grad_(), norms, None, None, None, None, torch.float32, operands=trained)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_operands_are_held_per_parameter_version(monkeypatch, dtype):
    made = []
    real = ss.prepare_stage_operands

    def counted(*args):
        made.append(args[-1])
        return real(*args)

    monkeypatch.setattr(sincnet_module, "prepare_stage_operands", counted)
    net, pooled = _net(dtype=dtype), _pooled(1, 150)
    with torch.no_grad():
        first = net(None, pooled=pooled)
        assert torch.equal(net(None, pooled=pooled), first) and made == [dtype]
        ops = net._held_operands[("sinc_stages", dtype)][1]
        assert ops.dtype == dtype and ops.wt2.shape == (2, 64, 416) and ops.wt3.shape == (2, 64, 320)
        net.conv3.bias.add_(0.5)  # a new version of one parameter: made again
        assert not torch.equal(net(None, pooled=pooled), first) and made == [dtype] * 2
    # none where a parameter trains: the raw ones go in, and get their gradient
    net.conv2.weight.requires_grad_(True)
    out = net(None, pooled=pooled)
    assert made == [dtype] * 2
    out.sum().backward()
    assert net.conv2.weight.grad is not None and net.conv2.weight.grad.abs().sum() > 0


def _plain_launch(pooled, norms, ops):
    """``_launch`` stood in by the plain version on the prepared raw inputs."""
    return ss.sinc_stages_reference(pooled, norms, ops.w2, ops.b2, ops.w3, ops.b3, ops.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_function_gradient_is_the_compositions(monkeypatch, dtype):
    monkeypatch.setattr(ss, "_launch", _plain_launch)
    net, pooled = _net(dtype=dtype), _pooled(2, 140)
    leaves = [pooled.clone().requires_grad_(), *(p.detach().clone().requires_grad_() for p in _norms(net)),
              *(p.detach().clone().requires_grad_() for p in _convs(net))]
    ops = ss.prepare_stage_operands(*(t.detach() for t in leaves[7:]), dtype)
    cotangent = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 60, ss.frames(140)[1])).astype(np.float32))
    got = ss.SincStagesFunction.apply(*leaves, ops)
    grads = torch.autograd.grad((got * cotangent).sum(), leaves)
    want = ss.sinc_stages_reference(leaves[0], leaves[1:7], *leaves[7:], dtype)
    wants = torch.autograd.grad((want * cotangent).sum(), leaves)
    assert torch.equal(got, want)
    for g, w in zip(grads, wants):
        assert torch.equal(g, w)


def _fake_library():
    """The library's C entry as ``_signature`` declares it, recording each
    call's arguments."""
    calls = []

    def launch(*args):
        assert len(args) == len(launch.argtypes)
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(sinc_stages_launch=launch, calls=calls)
    ss._signature(lib)
    return lib


def test_launches_count_only_the_kernels(monkeypatch):
    net, pooled = _net(), _pooled(3, 2658)
    before = ss.sinc_stages.launches
    with torch.no_grad():
        net(None, pooled=pooled)  # the CPU route: no launch
    assert ss.sinc_stages.launches == before
    # the launch itself on a stand-in library: one launch set a call, the
    # plan's numbers passed, the batch stride of a stacked half
    lib = _fake_library()
    monkeypatch.setattr(ss._build, "library", lambda name, sig: lib)
    monkeypatch.setattr(ss._build, "num_sms", lambda dev: 132)
    monkeypatch.setattr(ss._build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(ss._build, "check", lambda lib_, name, err: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    both = _pooled(3, 2658).repeat(1, 2, 1)
    out = ss._launch(both[:, 80:], _norms(net), ss.prepare_stage_operands(*_convs(net), torch.bfloat16))
    assert ss.sinc_stages.launches == before + 1 and out.shape == (3, 60, 293)
    (args,) = lib.calls
    plan = ss.launch_plan(3, 2658, 132)
    want = (3, 2658, *(plan[k] for k in ("p2", "p3", "tiles2", "tiles3", "grid2", "grid3")), 1)
    assert args[1] == 160 * 2658 and args[-10:-1] == want


# --------------------------------------------------------------------- #
# replays of the kernels' arithmetic


def _tile_product(xs, wt, cin_pad, split):
    """The tile's conv (128 frames x 64 channels) as the kernels form it
    (``a_fragment``, ``conv_tile``, ``store_tile``), in float64: warp w's
    A fragment of k8 step s (tap s // (C / 8), channels 8 (s % (C / 8)) + t
    and + 4) reads rows 16 w + g and + 8 of xs (channels x frames) a tap
    later, in the ``wgmma`` / ``mma`` m16n8k8 layout (A[g][t], A[g+8][t],
    A[g][t+4], A[g+8][t+4]); B is W^T's columns 8 s to 8 s + 8; ``split``
    takes lo.hi + hi.lo + hi.hi with A split as ``split_tf32`` splits it,
    else hi.hi."""
    steps = cin_pad // 8
    lanes = torch.arange(32)
    g, t = lanes // 4, lanes % 4
    out = torch.zeros(64, 128, dtype=torch.float64)
    for w in range(8):
        d = torch.zeros(16, 64, dtype=torch.float64)
        for s in range(5 * steps):
            tap, cs = divmod(s, steps)
            a = torch.zeros(16, 8, dtype=torch.float32)
            row, c0, c1 = 16 * w + g + tap, 8 * cs + t, 8 * cs + t + 4
            a[g, t], a[g + 8, t] = xs[c0, row], xs[c0, row + 8]
            a[g, t + 4], a[g + 8, t + 4] = xs[c1, row], xs[c1, row + 8]
            bh, bl = wt[0, :, 8 * s: 8 * s + 8].double().T, wt[1, :, 8 * s: 8 * s + 8].double().T
            if split:
                ah, al = (v.double() for v in _numerics.split_tf32(a))
                d += al @ bh + ah @ bl + ah @ bh
            else:
                d += a.double() @ bh
        out[:, 16 * w: 16 * w + 16] = d.T
    return out


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_prepared_weights_replay_the_convolution(stage, dtype):
    cin, cin_pad, k_pad = (80, 80, 416) if stage == 2 else (60, 64, 320)
    gen = torch.Generator().manual_seed(stage)
    w = torch.randn(60, cin, 5, generator=gen) / 20
    wt = ss._transposed(w, dtype)
    assert wt.shape == (2, 64, k_pad)
    # zero on the padded output channels, input channels and slice
    padded = torch.ones(64, k_pad, dtype=torch.bool)
    padded[:60, : 5 * cin_pad] = (torch.arange(5 * cin_pad) % cin_pad >= cin)[None]
    assert torch.equal(wt[:, padded], torch.zeros(2, int(padded.sum())))
    xs = torch.zeros(cin_pad, 136)
    xs[:cin, :132] = torch.randn(cin, 132, generator=gen)
    if dtype == torch.bfloat16:
        xs = xs.bfloat16().float()
    got = _tile_product(xs, wt, cin_pad, split=dtype == torch.float32)
    w_used = w.to(dtype).double()
    want = F.conv1d(xs[None, :cin, :132].double(), w_used)[0]  # (60, 128)
    scale = F.conv1d(xs[None, :cin, :132].double().abs(), w_used.abs())[0]
    assert ((got[:60] - want).abs() / scale).max() < (2.0**-20 if dtype == torch.float32 else 1e-12)
    assert torch.equal(got[60:], torch.zeros(4, 128, dtype=torch.float64))


def test_bf16_operands_are_tf32_exact():
    """At bf16 the kernels take one TF32 product of bf16-rounded operands:
    a bf16 value is a TF32 value, so the product is a bf16 product's."""
    w = torch.randn(60, 80, 5, generator=torch.Generator().manual_seed(4))
    hi, lo = ss._transposed(w, torch.bfloat16)
    assert torch.equal(_numerics.split_tf32(hi)[0], hi) and torch.equal(lo, torch.zeros_like(lo))
    assert torch.equal(hi.bfloat16().float(), hi)


def test_three_tf32_products_hold_f32_accuracy():
    """conv2's sums at SincNet's width (K = 400) as the f32 kernels take
    them: lo.hi + hi.lo and hi.hi, each product exact: within a few f32
    roundings of the exact sum; one TF32 product is orders of magnitude off."""
    gen = torch.Generator().manual_seed(5)
    x = F.leaky_relu(torch.randn(1, 80, 300, generator=gen), 0.01)
    w = torch.randn(60, 80, 5, generator=gen) / 20
    exact = F.conv1d(x.double(), w.double())
    (xh, xl), (wh, wl) = _numerics.split_tf32(x), _numerics.split_tf32(w)
    three = (F.conv1d(xl.double(), wh.double()) + F.conv1d(xh.double(), wl.double())) \
        + F.conv1d(xh.double(), wh.double())
    one = F.conv1d(xh.double(), wh.double())
    scale = F.conv1d(x.double().abs(), w.double().abs())
    assert ((three - exact).abs() / scale).max() < 2.0**-20
    assert ((one - exact).abs() / scale).max() > 2.0**-16


def test_tile_statistics_merge_to_the_norms():
    """norm2's statistics as the kernels take them: each tile's (mean, M2)
    over its pooled frames (in f32), merged in tile order by Chan's formula
    (f32), against the two-pass mean and biased variance."""
    p2 = 884
    x = torch.from_numpy(np.random.default_rng(6).normal(3.0, 2.0, size=(4, p2)).astype(np.float32))
    for row in x:
        n = mean = m2 = None
        for p0 in range(0, p2, ss.TILE):
            v = row[p0: p0 + ss.TILE]
            nt = torch.tensor(float(v.numel()))
            mt = v.sum() / nt
            qt = ((v - mt) ** 2).sum()
            if n is None:
                n, mean, m2 = nt, mt, qt
                continue
            tot = n + nt
            d = mt - mean
            mean = mean + d * (nt / tot)
            m2 = m2 + qt + d * d * (n * nt / tot)
            n = tot
        assert n == p2
        assert torch.allclose(mean, row.mean(), rtol=1e-6, atol=0)
        assert torch.allclose(m2 / n, row.var(correction=0), rtol=1e-5, atol=0)


def test_constants_match_the_source():
    text = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTile") == ss.TILE and const("kTaps") == ss.TAPS and const("kPool") == ss.POOL
    assert const("kIn1") == ss.C_IN and const("kOut") == ss.C_OUT and const("kN") == ss.N_PAD
    assert const("kSlice") == ss.SLICE and const("kBlocksPerSm") == ss.BLOCKS_PER_SM
    rows, threads = const("kRows"), const("kThreads")
    assert rows == 2 * 64 and threads == 2 * 128  # two warpgroups, an m64 each
    span = rows + ss.TAPS - 1
    assert ss.POOL * ss.TILE <= rows
    # shared strides: the A loads (8 t + g) and the C stores (8 t + 4 (i & 1) + g) in 32 banks
    assert const("kSX") % 32 == 8 and const("kSX") >= span and const("kSY") % 32 == 4 and const("kSY") >= rows
    # a block's shared memory: the ring of W^T slices (hi and lo), the tile, the norm's
    # parameters; two blocks an SM of 228 KB, each with 1 KB the system keeps
    stages, b_bytes = const("kStages"), 64 * ss.SLICE * 4
    for cin_pad in (80, 64):
        smem = 1024 + stages * 2 * b_bytes + 4 * (cin_pad * const("kSX") + 4 * cin_pad + 64)
        assert ss.BLOCKS_PER_SM * (smem + 1024) <= 233472 and cin_pad * const("kSX") >= 64 * const("kSY")


@pytest.mark.parametrize("batch,p1", [(1, 2658), (256, 2658), (7, 1001), (3, 25), (528, 2658)])
def test_launch_plan_covers_every_output(batch, p1):
    plan = ss.launch_plan(batch, p1, 132)
    p2, p3 = ss.frames(p1)
    assert (plan["p2"], plan["p3"]) == (p2, p3) and p3 >= 1
    for pooled, tiles in ((p2, plan["tiles2"]), (p3, plan["tiles3"])):
        assert (tiles - 1) * ss.TILE < pooled <= tiles * ss.TILE
    assert plan["grid2"] == min(batch * plan["tiles2"], 264) and plan["grid3"] == min(batch, 264)
    # a pooled frame's conv frames lie in the tile's 128, their inputs in the
    # input that exists (frames past it only feed conv frames no pool reads)
    assert ss.POOL * ss.TILE <= 128 and ss.POOL * p2 - 1 <= p1 - ss.TAPS
