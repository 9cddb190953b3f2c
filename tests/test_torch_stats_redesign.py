"""What the tensor-core designs of the stats head (``linear_stats``) and the
attention statistics (``attn_stats``) add outside their CUDA kernels, held
on the CPU: the 3xTF32 argument for f32-accurate logits, the kernels' merge
order (frames in a thread, tile by tile, then the quad), their launch plans,
and the operands the models prepare once. The kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diart_tpu.ops.pallas_attn_stats import fused_attentive_stats as jax_fused_attn
from diart_tpu.ops.pallas_stats import fused_linear_stats as jax_fused_linear_stats
from diart_tpu_torch.ops import attn_stats, linear_stats
from diart_tpu_torch.ops.attn_stats import (
    AttnOperands,
    attentive_stats_reference,
    fused_attentive_stats,
    prepare_attn_operands,
    split_tf32,
)
from diart_tpu_torch.ops.linear_stats import (
    StatsOperands,
    fused_linear_stats,
    linear_stats_reference,
    prepare_stats_operands,
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _attn_inputs(seed, batch, time, channels, hdim, speakers):
    """The inputs chip_smoke.py gives the kernel, made with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(batch, time, channels)
    hidden = np.tanh(f(batch, time, hdim))
    w2 = f(hdim, channels) * hdim**-0.5
    b2 = f(channels) * 0.1
    weights = (1.0 / (1.0 + np.exp(-f(batch, speakers, time)))).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, hidden, w2, b2, weights)))


def _stats_inputs(seed, batch, time, c_in, channels, speakers):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(batch, time, c_in)
    w = f(c_in, channels) * c_in**-0.5
    b, scale, shift = f(channels) * 0.1, 1.0 + 0.1 * f(channels), 0.1 * f(channels)
    weights = (1.0 / (1.0 + np.exp(-f(batch, speakers, time)))).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, w, b, scale, shift, weights)))


def _held(got, want, rel, floor=0.0):
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    return err, rel * max(floor, max(w.abs().max().item() for w in want))


# ----------------------------------------------------------------------- #
# (a) 3xTF32: f32-accurate logits from the TF32 tensor cores


def test_split_tf32_rounds_to_nearest_ties_away():
    bits = torch.tensor([0x3F801000, 0x3F800FFF, 0x3F803000, 0x00000000, 0x7F7FFFFF],
                        dtype=torch.int64).to(torch.int32)
    v = torch.cat([bits.view(torch.float32), -bits.view(torch.float32)])
    hi, lo = split_tf32(v)
    # 1 + 2^-11 is a tie: away from zero, either sign; just below it rounds down;
    # 1 + 3 * 2^-11 is a tie between odd and even: away from zero again
    want = [0x3F802000, 0x3F800000, 0x3F804000, 0, 0x7F800000]
    assert hi[:5].view(torch.int32).tolist() == want
    assert (-hi[5:]).view(torch.int32).tolist() == want
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = split_tf32(x)
    assert ((x - hi).abs() <= x.abs() * 2.0**-11).all()  # 10 mantissa bits, to nearest
    assert ((x - hi - lo).abs() <= x.abs() * 2.0**-21).all()  # hi + lo keeps ~21 bits


# The kernel's tolerance on the card, unchanged: 1e-5 x max(1, max|ref|).
ATTN_TOL = 1e-5


def test_three_tf32_products_hold_the_f32_tolerance_and_one_does_not():
    """At the ECAPA width (B=2, T=501, H=128, C=1536): the plain version fed
    logits hi.hi + hi.lo + lo.hi (each product exact, sums in f32, as the
    tensor cores do) stays within the tolerance of the f32 version; one TF32
    pass (lo dropped) lands outside it, so the check sees a missing term."""
    x, hidden, w2, b2, weights = _attn_inputs(7, 2, 501, 1536, 128, 4)
    want = attentive_stats_reference(x, hidden, w2, b2, weights)
    (hh, hl), (wh, wl) = split_tf32(hidden), split_tf32(w2)
    three = hh @ wh + hh @ wl + hl @ wh + b2
    one = hh @ wh + b2
    err3, tol = _held(attn_stats._stats_from_logits(x, three, weights), want, ATTN_TOL, floor=1.0)
    err1, _ = _held(attn_stats._stats_from_logits(x, one, weights), want, ATTN_TOL, floor=1.0)
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)
    assert err1 > 10 * err3


# ----------------------------------------------------------------------- #
# (b) the merge order of the kernels, replayed in plain PyTorch


def _thread_frames(values, tile, groups, time_axis=1):
    """Pad the time axis of ``values`` to whole tiles and split it as the
    kernel's threads own frames: frame = tile * n + group * 64 + 8 j + 2 tig
    + h -> (..., tiles, groups, j, tig, h, ...)."""
    t = values.shape[time_axis]
    tiles = -(-t // tile)
    pad = [0, 0] * (values.dim() - 1 - time_axis) + [0, tiles * tile - t]
    v = F.pad(values, pad)
    shape = list(v.shape)
    shape[time_axis:time_axis + 1] = [tiles, groups, tile // groups // 8, 4, 2]
    return v.reshape(shape)


def linear_stats_replay(x, w, b, scale, shift, weights, slope=0.01):
    """``linear_stats_wgmma``'s sums: each thread (channel, tig) sums its own
    frames (144-frame tiles, frames 8 j + 2 tig + h) over the stream, then
    the quad's 4 lanes are added."""
    y = x.float() @ w.to(x.dtype).float() + b
    z = torch.where(y >= 0, y, slope * y) * scale + shift  # (B, T, C)
    zt = _thread_frames(z, 144, 1)[:, :, 0]  # (B, tiles, j, tig, h, C)
    wt = _thread_frames(weights.float(), 144, 1, time_axis=2)[:, :, :, 0]  # (B, S, tiles, j, tig, h)
    per_thread = [torch.einsum("bnjqhc,bsnjqh->bsqc", zt**p, wt) for p in (1, 2)]
    return tuple(v.sum(dim=2) for v in per_thread)


def attn_stats_replay(x, hidden, w2, b2, weights):
    """``attn_stats_tc``'s online softmax: each thread (channel, tig) walks
    its frames tile by tile (64-frame tiles, frames 8 j + 2 tig + h),
    rescaling when its max rises; then the quad's 4 lanes merge, max
    first."""
    time = x.shape[1]
    speakers = weights.shape[1]
    logits = hidden.float() @ w2.float() + b2.float()
    # (tiles, j, tig, h) -> (tiles, tig, j, h)
    valid = (_thread_frames(torch.ones(1, time, 1), 64, 1)[0, :, 0, ..., 0] > 0).transpose(1, 2)
    lt = _thread_frames(logits, 64, 1)[:, :, 0].permute(0, 5, 1, 3, 2, 4)  # (B, C, tiles, tig, j, h)
    xt = _thread_frames(x.float(), 64, 1)[:, :, 0].permute(0, 5, 1, 3, 2, 4)
    wt = _thread_frames(weights.float(), 64, 1, time_axis=2)[:, :, :, 0].permute(0, 1, 2, 4, 3, 5)
    inf = torch.tensor(-math.inf)
    m = torch.full(lt.shape[:2] + (4,), -math.inf)
    l = torch.zeros_like(m)
    sums = torch.zeros(m.shape + (speakers, 3))
    for n in range(lt.shape[2]):
        ln, vn = lt[:, :, n], valid[n]
        tmax = torch.where(vn, ln, inf).amax(dim=(-2, -1))
        mn = torch.maximum(m, tmax)
        sc = torch.where(mn == -math.inf, torch.ones_like(m), torch.exp(m - mn))
        l, sums, m = l * sc, sums * sc[..., None, None], mn
        e = torch.where(vn, torch.exp(ln - mn[..., None, None]), torch.zeros(()))
        ex = e * xt[:, :, n]
        l = l + e.sum(dim=(-2, -1))
        w = wt[:, :, n]  # (B, S, tig, j, h)
        terms = [torch.einsum("bcqjh,bsqjh->bcqs", v, w) for v in (e, ex, ex * xt[:, :, n])]
        sums = sums + torch.stack(terms, dim=-1)
    mq = m.amax(dim=2, keepdim=True)  # the quad: max first, then the rescaled sums
    f = torch.where(m == -math.inf, torch.zeros(()), torch.exp(m - mq))
    l, sums = (l * f).sum(2), (sums * f[..., None, None]).sum(2)
    out = sums / l[..., None, None]  # (B, C, S, 3)
    return tuple(out[..., i].transpose(1, 2) for i in range(3))


# T = 1 leaves every thread but one of each quad with no frame below T;
# T = 145 a last tile with one frame (both kernels); C = 100 and 1500 a
# partial channel tile; S from 1 to 8.
REPLAY_CASES = [(2, 1, 100, 1), (2, 145, 100, 8), (1, 279, 1500, 4), (3, 37, 64, 2), (1, 200, 160, 5)]


@pytest.mark.parametrize("batch,time,channels,speakers", REPLAY_CASES)
def test_attn_stats_merge_order_matches_reference(batch, time, channels, speakers):
    args = _attn_inputs(time + channels, batch, time, channels, 64, speakers)
    want = attentive_stats_reference(*args)
    err, tol = _held(attn_stats_replay(*args), want, ATTN_TOL, floor=1.0)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("batch,time,channels,speakers", REPLAY_CASES)
def test_linear_stats_merge_order_matches_reference(batch, time, channels, speakers):
    args = _stats_inputs(time + channels, batch, time, 64, channels, speakers)
    want = linear_stats_reference(*args)
    err, tol = _held(linear_stats_replay(*args), want, 1e-5)
    assert err <= tol, (err, tol)


# ----------------------------------------------------------------------- #
# (c) the launch plans


def _coverage(plan, batch, channels):
    count = np.zeros((batch, channels), int)
    gx, gy = plan["grid"]
    per, ct = plan["streams_per_block"], plan["channel_tile"]
    assert gx <= 2**31 - 1 and gy <= 65535
    for by in range(gy):
        assert by * per < batch  # no block without a stream
        for bx in range(gx):
            assert bx * ct < channels
            count[by * per:(by + 1) * per, bx * ct:(bx + 1) * ct] += 1
    return count


# (T, C, shared memory, X's dtype) with the shared memory that the kernels'
# sources give each call (``linear_stats_wgmma_smem`` / ``attn_stats_smem``;
# 0: the FMA route). The plans are pure arithmetic on it; the layout and the
# 227 KB budget are the sources' own (linear_stats.cu's route rule,
# attn_stats.cu's static_assert). linear_stats: bf16 at C_in = 512 with S =
# 4 and 8, C_in = 200 with S = 1; then the FMA route: f32 at C_in = 60,
# bf16 at C_in = 1024 (too wide), f32 at C_in = 100; then the TF32 route
# (f32, C_in % 8 == 0: the X ring and the weights only) with S = 4 and 8.
# attn_stats: bf16 x with S = 4, then f32 x with S = 8.
BF16, F32 = torch.bfloat16, torch.float32
STATS_PLAN_CASES = [
    (279, 1500, 208128, BF16), (37, 100, 210432, BF16), (600, 1536, 140864, BF16),
    (279, 1500, 0, F32), (279, 1500, 0, BF16), (9, 100, 0, F32),
    (279, 1500, 187648, F32), (600, 1536, 189952, F32),
]
ATTN_PLAN_CASES = [(501, 1536, 149488), (37, 100, 166896), (600, 1500, 166896), (1, 1536, 166896)]


@pytest.mark.parametrize("batch", [1, 3, 64, 256])
@pytest.mark.parametrize("case", range(len(STATS_PLAN_CASES)))
def test_linear_stats_plan_covers_every_output_once(batch, case):
    time, channels, smem, dtype = STATS_PLAN_CASES[case]
    plan = linear_stats.launch_plan(batch, time, channels, smem, 132, dtype)
    assert (_coverage(plan, batch, channels) == 1).all()
    route = {BF16: "wgmma", F32: "wgmma_tf32"}[dtype] if smem else "fma"
    assert plan["smem"] == smem and plan["route"] == route
    assert plan["frame_tiles"] * plan["frame_tile"] >= time
    if smem:  # about one block a multiprocessor
        assert plan["grid"][0] * plan["grid"][1] <= max(132, plan["grid"][0])
    else:
        assert plan["streams_per_block"] == 1


def test_linear_stats_plan_at_the_xvector_head():
    """279 frames in two 144-frame tiles, 12 channel tiles, 11 blocks of 6
    streams each; one stream or three take one stream a block."""
    plan = linear_stats.launch_plan(64, 279, 1500, 208128, 132)
    assert plan["frame_tiles"] == 2 and plan["grid"] == (12, 11) and plan["streams_per_block"] == 6
    assert linear_stats.launch_plan(3, 279, 1500, 208128, 132)["streams_per_block"] == 1


@pytest.mark.parametrize("batch", [1, 3, 64, 256])
@pytest.mark.parametrize("case", range(len(ATTN_PLAN_CASES)))
def test_attn_stats_plan_covers_every_output_once(batch, case):
    time, channels, smem = ATTN_PLAN_CASES[case]
    plan = attn_stats.launch_plan(batch, time, channels, smem, 132)
    assert (_coverage(plan, batch, channels) == 1).all()
    assert plan["smem"] == smem and plan["frame_tiles"] * plan["frame_tile"] >= time
    assert plan["grid"][0] * plan["grid"][1] <= max(132, plan["grid"][0])


def test_attn_stats_plan_at_the_ecapa_head():
    """12 channel tiles, 11 blocks of 6 streams each, 8 frame tiles."""
    plan = attn_stats.launch_plan(64, 501, 1536, 149488, 132)
    assert plan["grid"] == (12, 11) and plan["streams_per_block"] == 6 and plan["frame_tiles"] == 8


@pytest.mark.parametrize("hdim", [12, 136])
def test_attn_stats_kernel_refuses_widths_it_does_not_take(hdim):
    """H % 8 != 0 or H > 128 raises before any launch (W2^T's rows live in
    the kernel's registers); the plain version takes any H."""
    x, hidden, w2, b2, weights = _attn_inputs(8, 1, 9, 16, hdim, 2)
    ops = prepare_attn_operands(w2, b2)
    with pytest.raises(ValueError, match="H % 8 == 0 and H <= 128"):
        attn_stats._launch(x, hidden, ops, weights)
    assert all(map(torch.equal, fused_attentive_stats(x, hidden, weights=weights, operands=ops),
                   attentive_stats_reference(x, hidden, w2, b2, weights)))


# ----------------------------------------------------------------------- #
# (d) the prepared operands


def test_prepared_operands_compute_what_raw_ones_do():
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b, scale, shift, weights = _stats_inputs(3, 2, 29, 64, 100, 3)
        x = x.to(dtype)
        ops = prepare_stats_operands(w, b, scale, shift, dtype)
        assert isinstance(ops, StatsOperands) and ops.w.dtype == dtype and ops.channels == 100
        assert ops.w.shape[1] == (100 if dtype == torch.float32 else 104)
        assert not ops.w[:, 100:].any()
        got = fused_linear_stats(x, weights=weights, operands=ops)
        assert all(map(torch.equal, got, fused_linear_stats(x, w, b, scale, shift, weights)))
    x, hidden, w2, b2, weights = _attn_inputs(4, 2, 37, 100, 40, 2)
    ops = prepare_attn_operands(w2, b2)
    assert isinstance(ops, AttnOperands) and tuple(ops.hi.shape) == (100, 64)
    assert torch.equal(ops.hi[:, :40] + ops.lo[:, :40], sum(split_tf32(w2.t().contiguous())))
    assert not ops.hi[:, 40:].any() and not ops.lo[:, 40:].any()
    got = fused_attentive_stats(x, hidden, weights=weights, operands=ops)
    assert all(map(torch.equal, got, fused_attentive_stats(x, hidden, w2, b2, weights)))
    with pytest.raises(ValueError):
        fused_attentive_stats(x, hidden, None, b2, weights, operands=ops)
    with pytest.raises(ValueError, match="prepared for"):  # operands for bf16, f32 x
        fused_linear_stats(x, weights=weights, operands=prepare_stats_operands(
            *_stats_inputs(3, 2, 37, 100, 8, 2)[1:5], torch.bfloat16))


# Prepared operands against the Pallas kernels in interpret mode: the f32
# tolerance of tests/test_torch_kernels.py and tests/test_torch_ecapa.py.
def test_prepared_operands_match_pallas():
    x, w, b, scale, shift, weights = _stats_inputs(5, 2, 29, 64, 300, 4)
    got = fused_linear_stats(x, weights=weights, operands=prepare_stats_operands(w, b, scale, shift, x.dtype))
    want = jax_fused_linear_stats(*map(jnp.asarray, (x, w, b, scale, shift, weights)), interpret=True)
    for g, k in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=1e-5, atol=1e-4)
    x, hidden, w2, b2, weights = _attn_inputs(6, 2, 41, 192, 128, 4)
    got = fused_attentive_stats(x, hidden, weights=weights, operands=prepare_attn_operands(w2, b2))
    want = jax_fused_attn(*map(jnp.asarray, (x, hidden, w2, b2, weights)), interpret=True)
    for g, k, atol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=1e-5, atol=atol)
