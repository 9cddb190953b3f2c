"""The f32 routes of the SE-Res2Block (``se_res2``) and the stats head
(``linear_stats``) on the TF32 tensor cores (3xTF32), held on the CPU: the
operands the wrappers prepare for them (transposed, split, padded, in the
kernels' order), a replay of each route's arithmetic (both operands split by
``split_tf32``, ``lo.hi + hi.lo + hi.hi`` accumulated k8 step by k8 step
in the kernels' k order) against the plain f32 versions within the card's
unchanged tolerances, the route rules, and the launch plans. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diart_tpu_torch.ops import attn_stats, linear_stats, se_res2
from diart_tpu_torch.ops._numerics import split_tf32
from diart_tpu_torch.ops.functional import reflect_index
from test_torch_stats_redesign import _coverage, _held, _stats_inputs, _thread_frames

CSRC = Path(linear_stats.__file__).resolve().parents[1] / "csrc"

# The card's tolerances, unchanged (chip_smoke.py): the block within 1e-4 of
# max(1, max|ref|), the stats head within 1e-5 of max|ref|.
RES2_TOL = 1e-4
STATS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tf32_product(a, b, acc=None, terms=3, split=False):
    """``acc + a @ b`` (a (..., K), b (K, N), K % 8 == 0) as the f32 routes
    compute it: both operands split into TF32 hi and lo, and each k8 step,
    in k order, adds lo.hi, hi.lo and hi.hi to an f32 sum (each product of
    two 11-bit significands is exact in f32). ``split``: hi.hi and the small
    terms in two sums, added at the end (``tdnn_wgmma_tf32``). ``terms=1``
    keeps hi.hi only: one TF32 product."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    acc = torch.zeros(a.shape[:-1] + (b.shape[1],)) if acc is None else acc
    small = torch.zeros_like(acc) if split else acc
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        if terms == 3:
            small = small + al[..., s] @ bh[s]
            small = small + ah[..., s] @ bl[s]
            if not split:
                acc = small
        acc = acc + ah[..., s] @ bh[s]
        if not split:
            small = acc
    return acc + small if split else acc


# ----------------------------------------------------------------------- #
# (a) the SE-Res2Block


GROUPS, WIDTH, CHANS, SE_HIDDEN = 7, 64, 512, 128


def _res2_params(seed):
    """Unit-gain parameters at the ECAPA geometry (chip_smoke.py's scales)."""
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    mk = lambda *s: n(*s, scale=0.5 / np.sqrt(s[-2]))
    return (
        mk(CHANS, CHANS), 0.1 * n(CHANS), 1 + 0.1 * n(CHANS), 0.1 * n(CHANS),
        n(GROUPS, 3, WIDTH, WIDTH, scale=0.5 / np.sqrt(3 * WIDTH)),
        0.1 * n(GROUPS, WIDTH), 1 + 0.1 * n(GROUPS, WIDTH), 0.1 * n(GROUPS, WIDTH),
        mk(CHANS, CHANS), 0.1 * n(CHANS), 1 + 0.1 * n(CHANS), 0.1 * n(CHANS),
        mk(CHANS, SE_HIDDEN), 0.1 * n(SE_HIDDEN), mk(SE_HIDDEN, CHANS), 0.1 * n(CHANS),
    )


def res2_replay(x, params, dilation, terms=3):
    """The f32 block on the TF32 routes: both 1x1 TDNNs (hi.hi and the
    small terms in two sums, as ``tdnn_wgmma_tf32``) and every tap of the
    cascade (one sum, tap by tap, as ``res2_cascade_tf32`` walks them)
    through :func:`tf32_product`; the epilogues, the gate MLP (``se_gate``:
    FMAs) and the residual in f32. Returns (z1, the concat, the block's
    output): stage 0, stage 7 and the block."""
    w1, b1, a1, c1, wg, bg, ag, cg, w2, b2, a2, c2, ws1, bs1, ws2, bs2 = params
    tdnn = lambda v, w, b, a, c: torch.relu(tf32_product(v, w, terms=terms, split=True) + b) * a + c
    z1 = tdnn(x, w1, b1, a1, c1)
    chunks = torch.split(z1, WIDTH, dim=-1)
    pad, time = dilation, x.shape[1]  # 3 taps
    outputs, y = [chunks[0]], None
    for i in range(GROUPS):
        inp = chunks[i + 1] if y is None else chunks[i + 1] + y
        acc = None
        for j in range(3):
            idx = reflect_index(time, j * dilation - pad, time + j * dilation - pad, inp.device)
            acc = tf32_product(inp.index_select(1, idx), wg[i, j], acc, terms)
        y = torch.relu(acc + bg[i]) * ag[i] + cg[i]
        outputs.append(y)
    cat = torch.cat(outputs, dim=-1)
    z2 = tdnn(cat, w2, b2, a2, c2)
    s = torch.relu(z2.mean(dim=1) @ ws1 + bs1)
    return z1, cat, x + z2 * torch.sigmoid(s @ ws2 + bs2)[:, None, :]


@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_res2_three_tf32_products_hold_the_f32_tolerance_and_one_does_not(dilation):
    """At ECAPA's width (C = 512, 8 groups of 64, 3 taps) on 2 streams of 501
    frames, against the plain f32 stage mode and block: the 3xTF32 replay
    stays within the card's f32 tolerance (1e-4 of max(1, max|ref|)) at z1
    (stage 0), at the concat (stage 7) and at the block's output; one TF32
    product lands outside it at both stages, which the card checks too.
    At the block's output the residual x sets the scale (max |x| ~ 4.5
    against ~0.35 for what the block adds), and one TF32 product stays
    inside the tolerance there: the stages are what see a dropped term."""
    params = _res2_params(dilation)
    x = torch.from_numpy(np.random.default_rng(10 + dilation).normal(size=(2, 501, CHANS)).astype(np.float32))
    wants = (se_res2.se_res2_stage_reference(x, params, dilation, 0),
             se_res2.se_res2_stage_reference(x, params, dilation, GROUPS),
             se_res2.se_res2_block_reference(x, *params, dilation))
    three, one = res2_replay(x, params, dilation), res2_replay(x, params, dilation, terms=1)
    for what, want, got3, got1 in zip(("z1", "concat", "block"), wants, three, one):
        tol = RES2_TOL * max(1.0, want.abs().max().item())
        err3, err1 = (got3 - want).abs().max().item(), (got1 - want).abs().max().item()
        assert err3 <= tol, (what, err3, tol)
        assert err1 > 10 * err3, (what, err1, err3)
        if what != "block":
            assert err1 > tol, (what, err1, tol)


def test_res2_operands_unpack_exactly():
    """f32: w1s / w2s are w1^T / w2^T (output, input) split, hi then lo, and
    wgs each group's taps transposed and split, (G, 2, taps, W, W); bf16
    holds none."""
    params = _res2_params(0)
    ops = se_res2.kernel_operands(params, torch.float32)
    w1, wg, w2 = params[0], params[4], params[8]
    for got, w in ((ops.w1s, w1), (ops.w2s, w2)):
        assert tuple(got.shape) == (2, CHANS, CHANS) and got.is_contiguous()
        hi, lo = split_tf32(w.t())
        assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
        assert ((got.view(torch.int32) & 0x1FFF) == 0).all()  # both halves are TF32 values
    assert tuple(ops.wgs.shape) == (GROUPS, 2, 3, WIDTH, WIDTH) and ops.wgs.is_contiguous()
    for g in (0, 3, GROUPS - 1):
        for tap in range(3):
            hi, lo = split_tf32(wg[g, tap].t())
            assert torch.equal(ops.wgs[g, 0, tap], hi) and torch.equal(ops.wgs[g, 1, tap], lo)
    assert torch.equal(ops.wgs[2, 0, 1] + ops.wgs[2, 1, 1], sum(split_tf32(wg[2, 1].t())))
    bf = se_res2.kernel_operands(params, torch.bfloat16)
    assert bf.w1s.numel() == bf.wgs.numel() == bf.w2s.numel() == 0
    # the 16-tuple comes back whole either way
    assert all(torch.equal(a, b) for a, b in zip(ops.params(), params))


def _source_rule(name, fn):
    """The body of the definition of ``fn`` in ``csrc/<name>.cu``, on one
    line."""
    text = (CSRC / f"{name}.cu").read_text()
    m = re.search(rf"^\S[^\n]*\b{fn}\([^)]*\)\s*\{{", text, re.M)
    assert m, f"no definition of {fn} in {name}.cu"
    depth, at = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[at], 0)
        at += 1
    return " ".join(text[m.end():at - 1].split())


def test_res2_route_rule_is_the_sources():
    """launch_plan states csrc/se_res2.cu's rules: the TDNNs on the TF32
    tensor cores where K and N are multiples of 8, the cascade where its
    window and the taps' halves fit 227 KB of shared memory."""
    assert _source_rule("se_res2", "tf32_tdnn") == "return kdim % 8 == 0 && ndim % 8 == 0;"
    assert _source_rule("se_res2", "tf32_cascade") == "return cascade_tf32_smem(rows_cap, taps) <= kMaxSmem;"
    assert _source_rule("se_res2", "cascade_tf32_smem") == (
        "return 1024 + (size_t)rows_cap * 256 + (size_t)2 * taps * WIDTH * WIDTH * sizeof(float);")
    assert "constexpr size_t kMaxSmem = 232448;" in (CSRC / "se_res2.cu").read_text()
    assert se_res2.MAX_SMEM == 232448


# (batch, time, chans, taps, dilation, dtype) -> (tdnn, cascade, window rows)
RES2_ROUTES = [
    ((64, 501, 512, 3, 2, torch.bfloat16), ("tdnn_wgmma", "res2_cascade_mma", 126 + 28)),
    ((64, 501, 512, 3, 2, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_tf32", 251 + 28)),
    ((64, 501, 512, 3, 4, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_tf32", 251 + 56)),
    ((8, 501, 512, 3, 3, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_tf32", 72 + 42)),
    # the longest window the kernel takes (one tile of 512 frames): 3 taps fit
    ((200, 512, 512, 3, 4, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_tf32", 512)),
    # 5 taps at that window do not: the FMA cascade; at a short window they do
    ((200, 512, 512, 5, 2, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_fma", 512)),
    ((2, 200, 512, 5, 2, torch.float32), ("tdnn_wgmma_tf32", "res2_cascade_tf32", 67 + 56)),
    # a width that is not a multiple of 8 (no ECAPA block has one): the FMA TDNN
    ((2, 100, 100, 3, 2, torch.float32), ("tdnn_fma", "res2_cascade_tf32", 100)),
]


@pytest.mark.parametrize("case,want", RES2_ROUTES)
def test_res2_launch_plan_routes(case, want):
    batch, time, chans, taps, dilation, dtype = case
    plan = se_res2.launch_plan(batch, time, chans, taps, dilation, dtype, 132)
    assert (plan["tdnn"], plan["cascade"], plan["window_rows"]) == want
    assert plan["time_tile"] == se_res2.cascade_tile(batch, time, dtype, 132)
    assert plan["tdnn_row_tile"] == (64 if plan["tdnn"] == "tdnn_fma" else 128)
    if dtype == torch.float32:
        fits = plan["cascade_smem"] <= se_res2.MAX_SMEM
        assert fits == (plan["cascade"] == "res2_cascade_tf32")


# ----------------------------------------------------------------------- #
# (b) the stats head


def stats_replay(x, w, b, scale, shift, weights, terms=3, slope=0.01):
    """``linear_stats_wgmma_tf32``'s arithmetic: the product through
    :func:`tf32_product`, then the epilogue's sums in the kernel's order
    (each thread's own frames of 144-frame tiles over the stream, then the
    quad's 4 lanes)."""
    y = tf32_product(x, w, terms=terms) + b
    z = torch.where(y >= 0, y, slope * y) * scale + shift
    zt = _thread_frames(z, 144, 1)[:, :, 0]  # (B, tiles, j, tig, h, C)
    wt = _thread_frames(weights.float(), 144, 1, time_axis=2)[:, :, :, 0]  # (B, S, tiles, j, tig, h)
    per_thread = [torch.einsum("bnjqhc,bsnjqh->bsqc", zt**p, wt) for p in (1, 2)]
    return tuple(v.sum(dim=2) for v in per_thread)


# the x-vector head (T = 279) and XVector-SB's (T = 501), 512 -> 1500, S = 4
@pytest.mark.parametrize("time", [279, 501])
def test_stats_three_tf32_products_hold_the_f32_tolerance_and_one_does_not(time):
    args = _stats_inputs(time, 2, time, 512, 1500, 4)
    want = linear_stats.linear_stats_reference(*args)
    err3, tol = _held(stats_replay(*args), want, STATS_TOL)
    err1, _ = _held(stats_replay(*args, terms=1), want, STATS_TOL)
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)
    assert err1 > 10 * err3


@pytest.mark.parametrize("c_in,channels", [(512, 1500), (8, 100), (200, 128), (24, 129)])
def test_stats_fragments_unpack_exactly(c_in, channels):
    """wf holds W^T split, channels padded with zeros to whole 128-channel
    tiles, in the A-fragment order: for lane (g, tig) of warp v at k8 step
    k, hi then lo of rows 16 v + g (+ 8) at columns 8 k + tig (+ 4)."""
    w = _stats_inputs(c_in, 1, 1, c_in, channels, 1)[1]
    wf = linear_stats.pack_tf32(w)
    tiles = -(-channels // 128)
    assert tuple(wf.shape) == (tiles, c_in // 8, 8, 32, 8) and wf.is_contiguous()
    hi, lo = split_tf32(w.t())
    got_hi, got_lo = linear_stats.unpack_tf32(wf, channels)
    assert torch.equal(got_hi, hi) and torch.equal(got_lo, lo)
    for ct, k8, warp, lane in ((0, 0, 0, 0), (tiles - 1, c_in // 8 - 1, 7, 31), (0, c_in // 16, 3, 13)):
        g, tig = lane // 4, lane % 4
        for i in range(4):
            row = ct * 128 + 16 * warp + g + 8 * (i & 1)
            col = 8 * k8 + tig + 4 * (i >> 1)
            want = (hi[row, col], lo[row, col]) if row < channels else (0.0, 0.0)
            assert wf[ct, k8, warp, lane, i] == want[0] and wf[ct, k8, warp, lane, 4 + i] == want[1]


@pytest.mark.parametrize("c_in,dtype,tf32", [
    (512, torch.float32, True), (200, torch.float32, True), (8, torch.float32, True),
    (60, torch.float32, False), (100, torch.float32, False), (512, torch.bfloat16, False),
])
def test_stats_operands_carry_the_fragments_where_the_route_takes_them(c_in, dtype, tf32):
    """The route rule of csrc/linear_stats.cu (``route_of``): f32 with C_in %
    8 == 0 takes the TF32 tensor cores and reads ``wf``; f32 at any other
    C_in the FMA kernel; bf16 its own tensor-core kernel. The operands carry
    the fragments exactly where the rule sends the call."""
    rule = _source_rule("linear_stats", "route_of")
    assert rule.startswith("if (cin % 8 != 0) return 0; if (dtype == 0) return 2;"), rule
    w, b, scale, shift = _stats_inputs(1, 1, 1, c_in, 100, 1)[1:5]
    ops = linear_stats.prepare_stats_operands(w, b, scale, shift, dtype)
    assert (ops.wf.numel() > 0) == tf32
    if tf32:
        assert torch.equal(linear_stats.unpack_tf32(ops.wf, 100)[0], split_tf32(w.t())[0])


# (T, C, shared memory of the TF32 block, S): the X ring of 5 stages (hi and
# lo, 144 frames of 128 bytes) and one tile's speaker weights
TF32_PLAN_CASES = [(279, 1500, 187648, 4), (501, 1500, 187648, 4), (37, 100, 185920, 1), (600, 1536, 189952, 8)]


def test_stats_tf32_shared_memory_is_the_sources():
    text = (CSRC / "linear_stats.cu").read_text()
    assert "constexpr int LTST = 5;" in text and "constexpr int LN = 144;" in text
    assert _source_rule("linear_stats", "tf32_smem_bytes") == (
        "return 1024 + (size_t)LTST * 2 * LT_X_BYTES + sizeof(float) * speakers * LN;")
    for _, _, smem, speakers in TF32_PLAN_CASES:
        assert smem == 1024 + 5 * 2 * 144 * 128 + 4 * speakers * 144


@pytest.mark.parametrize("batch", [1, 3, 64, 256])
@pytest.mark.parametrize("case", range(len(TF32_PLAN_CASES)))
def test_stats_tf32_plan_covers_every_output_once(batch, case):
    time, channels, smem, _ = TF32_PLAN_CASES[case]
    plan = linear_stats.launch_plan(batch, time, channels, smem, 132, torch.float32)
    assert plan["route"] == "wgmma_tf32" and plan["smem"] == smem
    assert (_coverage(plan, batch, channels) == 1).all()
    assert plan["frame_tiles"] * plan["frame_tile"] >= time
    assert plan["grid"][0] * plan["grid"][1] <= max(132, plan["grid"][0])


def test_split_tf32_is_shared():
    """One split for every kernel's prepared operands (ops/_numerics.py),
    still importable where the attention statistics first had it."""
    assert attn_stats.split_tf32 is split_tf32 and "split_tf32" in attn_stats.__all__
