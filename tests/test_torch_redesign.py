"""What the redesigned kernels of the LSTM sweep and the SE-Res2Block add
outside their CUDA kernels, held on the CPU: the packs of ``w_hh`` for each
route of the sweep (fragment order, the split route's thread order, the FMA
route's), the BiLSTM's cache of them, and the time split of the group cascade
(tile, halo, reflection only at the sequence's ends). The kernels themselves
are held against the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from diart_tpu_torch.models.lstm import BiLSTM
from diart_tpu_torch.ops import se_res2
from diart_tpu_torch.ops.lstm_sweep import (
    SweepWeights,
    lstm_sweep_reference,
    lstm_sweep_tm,
    pack_w_hh,
    packed_gates,
    unpack_w_hh,
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _w_hh(seed, hidden):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(2, 4 * hidden, hidden)).astype(np.float32))


PACKS = [
    (128, torch.bfloat16, "mma"),
    (64, torch.bfloat16, "mma"),
    (16, torch.bfloat16, "fma"),  # a width the tensor-core route is not built for
    (24, torch.bfloat16, "fma"),  # not a multiple of 16
    (144, torch.bfloat16, "fma"),  # above the tensor-core route's 128
    (128, torch.float32, "split"),  # a cluster of 2 blocks
    (64, torch.float32, "split"),  # one block
    (136, torch.float32, "fma"),  # an f32 width the split route is not built for
    (8, torch.float32, "fma"),
]


@pytest.mark.parametrize("hidden,dtype,route", PACKS)
def test_pack_w_hh_unpacks_exactly(hidden, dtype, route):
    w_hh = _w_hh(hidden, hidden)
    packed = pack_w_hh(w_hh, dtype)
    assert packed.route == route and packed.hidden == hidden and packed.data.dtype == dtype
    assert packed.data.numel() == w_hh.numel() and packed.data.is_contiguous()
    if route == "mma":  # [d][warp][tile][k tile][lane][reg][2]: 16 bytes a lane
        assert tuple(packed.data.shape) == (2, hidden // 8, 2, hidden // 16, 32, 4, 2)
    if route == "split":  # [d][rank][16 float4s][thread][4]: 64 registers a thread
        assert tuple(packed.data.shape) == (2, hidden // 64, 16, 4 * hidden, 4)
    assert torch.equal(unpack_w_hh(packed), w_hh.to(dtype))


# The same products (exact in f32 for bf16 operands), summed in f32 in the
# kernel's order instead of the library's: values of magnitude ~sqrt(H), so
# 1e-4 absolute is a few f32 ulps of the largest sums.
@pytest.mark.parametrize("hidden,dtype,route", PACKS)
def test_packed_gates_match_the_recurrent_product(hidden, dtype, route):
    w_hh = _w_hh(hidden + 1, hidden)
    rng = np.random.default_rng(hidden)
    h = torch.from_numpy(rng.uniform(-1, 1, size=(2, 5, hidden)).astype(np.float32)).to(dtype)
    got = packed_gates(pack_w_hh(w_hh, dtype), h)
    want = torch.bmm(h.double(), w_hh.to(dtype).double().transpose(1, 2)).float()
    assert got.shape == (2, 5, 4 * hidden) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_fragment_order_gives_a_thread_the_four_gates_of_one_unit():
    """Rows g and g + 8 of a warp's two tiles are gates i, f and g, o of unit
    8 warp + g: what the accumulator layout of m16n8k16 hands one thread."""
    hidden = 64
    rows = torch.arange(4 * hidden, dtype=torch.float32).view(1, -1, 1).expand(2, -1, hidden)
    data = pack_w_hh(rows, torch.bfloat16).data.float()  # each entry: its row of w_hh
    for warp in range(hidden // 8):
        for lane in (0, 5, 31):
            unit = 8 * warp + lane // 4
            for tile in range(2):
                got = data[0, warp, tile, :, lane]  # (k tiles, 4 regs, 2)
                assert torch.equal(got[:, 0::2], torch.full_like(got[:, 0::2], 2 * tile * hidden + unit))
                assert torch.equal(got[:, 1::2], torch.full_like(got[:, 1::2], (2 * tile + 1) * hidden + unit))


@pytest.mark.parametrize("hidden,dtype", [(64, torch.bfloat16), (128, torch.bfloat16), (8, torch.float32)])
def test_lstm_sweep_raw_and_packed_agree(hidden, dtype):
    rng = np.random.default_rng(3)
    proj = torch.from_numpy(rng.normal(size=(9, 2, 3, 4 * hidden)).astype(np.float32)).to(dtype)
    w_hh = _w_hh(5, hidden) * (0.3 / np.sqrt(hidden / 8))
    want = lstm_sweep_reference(proj, w_hh)
    assert torch.equal(lstm_sweep_tm(proj, w_hh), want)
    assert torch.equal(lstm_sweep_tm(proj, operands=pack_w_hh(w_hh, dtype)), want)


def test_lstm_sweep_rejects_a_mismatched_pack():
    proj = torch.zeros(4, 2, 1, 64)
    with pytest.raises(ValueError):  # packed for bf16, stream f32
        lstm_sweep_tm(proj, operands=pack_w_hh(_w_hh(0, 16), torch.bfloat16))
    with pytest.raises(ValueError):  # packed for another H
        lstm_sweep_tm(proj, operands=pack_w_hh(_w_hh(0, 8), torch.float32))
    with pytest.raises(ValueError):
        pack_w_hh(torch.zeros(2, 60, 16), torch.float32)


def _bilstm(seed=0, hidden=16, layers=2):
    torch.manual_seed(seed)
    lstm = BiLSTM(12, hidden, layers).requires_grad_(False)
    for p in lstm.parameters():
        p.copy_(torch.randn_like(p) * 0.2)
    return lstm


def test_bilstm_packs_once_and_again_after_a_change(monkeypatch):
    """One pack a layer and stream dtype, taken again by the next forward,
    made again for the layer whose ``w_hh`` changed in place and for every
    layer after a load; each pack unpacks to its ``w_hh``."""
    from diart_tpu_torch.models import lstm as lstm_module
    from test_torch_operands import Spy

    spy = Spy()
    monkeypatch.setattr(lstm_module, "held_operands", spy)
    lstm = _bilstm()
    x = torch.randn(7, 2, 12)
    y0 = lstm(x)
    first = spy.operands()
    assert len(first) == 2 and all(isinstance(p, SweepWeights) for p in first)
    assert torch.equal(unpack_w_hh(first[0]), lstm.l0_w_hh)
    spy.clear()
    assert torch.equal(lstm(x), y0) and spy.made == 2
    assert all(a is b for a, b in zip(spy.operands(), first))  # the forward reused them
    spy.clear()
    lstm(x.to(torch.bfloat16))  # a bf16 stream: packs of its own
    assert spy.made == 4 and all(p.data.dtype == torch.bfloat16 for p in spy.operands())
    with torch.no_grad():
        lstm.l0_w_hh.mul_(0.5)  # in place: same storage, new version
    spy.clear()
    y1 = lstm(x)
    second = spy.operands()
    assert second[0] is not first[0] and second[1] is first[1] and spy.made == 5
    assert torch.equal(unpack_w_hh(second[0]), lstm.l0_w_hh)
    assert not torch.equal(y0, y1)

    other = _bilstm(seed=1)
    lstm.load_state_dict(other.state_dict())
    spy.clear()
    assert torch.equal(lstm(x), other(x))
    third = spy.operands()
    assert third[0] is not second[0] and torch.equal(unpack_w_hh(third[0]), other.l0_w_hh)


def test_bilstm_cached_forward_equals_raw_weights():
    lstm = _bilstm(seed=2)
    x = torch.randn(6, 3, 12)
    want = x
    for layer in range(lstm.num_layers):
        w_ih, b = getattr(lstm, f"l{layer}_w_ih"), getattr(lstm, f"l{layer}_b")
        proj = (want @ w_ih.reshape(8 * 16, -1).t()).view(6, 3, 2, 64) + b
        out = lstm_sweep_reference(proj.transpose(1, 2).contiguous(), getattr(lstm, f"l{layer}_w_hh"))
        want = torch.cat([out[:, 0], out[:, 1]], dim=-1)
    np.testing.assert_allclose(lstm(x).numpy(), want.numpy(), atol=1e-6)


# --------------------------------------------------------------------- #
# The cascade's time split.

GROUPS, WIDTH = 7, 64


def _cascade_inputs(seed, batch, time, dtype, integers=False):
    rng = np.random.default_rng(seed)
    chans = (GROUPS + 1) * WIDTH
    if integers:  # every f32 sum exact, whatever its order
        z1 = rng.integers(-3, 4, size=(batch, time, chans)).astype(np.float32)
        wg = rng.integers(-1, 2, size=(GROUPS, 3, WIDTH, WIDTH)) * (rng.random((GROUPS, 3, WIDTH, WIDTH)) < 0.02)
        bg = rng.integers(-1, 2, size=(GROUPS, WIDTH))
        ag, cg = np.ones((GROUPS, WIDTH)), np.zeros((GROUPS, WIDTH))
    else:
        z1 = rng.normal(size=(batch, time, chans))
        wg = rng.normal(size=(GROUPS, 3, WIDTH, WIDTH)) * (0.5 / np.sqrt(3 * WIDTH))
        bg = 0.1 * rng.normal(size=(GROUPS, WIDTH))
        ag, cg = 1 + 0.1 * rng.normal(size=(GROUPS, WIDTH)), 0.1 * rng.normal(size=(GROUPS, WIDTH))
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    return t(z1).to(dtype), t(wg), t(bg), t(ag), t(cg)


# (time, tile): the main path's length in the kernel's tiles for 64 streams
# (bf16: 126, f32: 251), for 2 streams (72) and in one tile; a length that is
# not a multiple of the tile; tiles shorter than the halo, so that both reflected ends fall
# inside one tile's window; T just above the largest pad (d = 4: pad 4),
# whole and cut in tiles of 2.
SPLITS = [(501, 126), (501, 251), (501, 501), (501, 72), (333, 67), (40, 16), (40, 7), (5, 5), (5, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("time,tile", SPLITS)
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_tiled_cascade_equals_cascade_every_stage(dilation, time, tile, dtype):
    z1, wg, bg, ag, cg = _cascade_inputs(time + tile + dilation, 2, time, dtype, integers=True)
    for run in range(1, GROUPS + 1):
        want = se_res2._cascade(z1, wg, bg, ag, cg, dilation, run)
        got = se_res2.cascade_tiled(z1, wg, bg, ag, cg, dilation, run, tile)
        assert torch.equal(got, want), f"stage {run}"
        assert not got[..., (run + 1) * WIDTH:].any()  # the later groups are zeros
    assert want.abs().max() > 8  # the groups did accumulate


# Real-valued inputs: the same arithmetic per output row, so the split
# changes nothing beyond the library's choice of summation order for a
# product of another height: 1e-5 of values of magnitude ~1.
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_tiled_cascade_real_inputs(dilation):
    z1, wg, bg, ag, cg = _cascade_inputs(dilation, 2, 501, torch.float32)
    want = se_res2._cascade(z1, wg, bg, ag, cg, dilation, GROUPS)
    got = se_res2.cascade_tiled(z1, wg, bg, ag, cg, dilation, GROUPS, 126)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_tiled_cascade_detects_a_tap_outside_its_window(monkeypatch):
    """The split's own guard: a reflection applied at a tile edge instead of
    the sequence's end would read outside the window."""
    z1, wg, bg, ag, cg = _cascade_inputs(1, 1, 40, torch.float32)
    real = torch.where

    def at_tile_edge(cond, a, b):  # reflect far too early: lands outside the window
        return real(cond, a - 1000, b)

    monkeypatch.setattr(torch, "where", at_tile_edge)
    with pytest.raises((AssertionError, IndexError, RuntimeError)):
        se_res2.cascade_tiled(z1, wg, bg, ag, cg, 4, GROUPS, 16)


@pytest.mark.parametrize("batch,time,dtype,sms,want", [
    (64, 501, torch.bfloat16, 132, 126),  # 4 tiles a stream: 256 blocks, two a multiprocessor
    (64, 501, torch.float32, 132, 251),   # 2 tiles: 128 blocks, one a multiprocessor
    (8, 501, torch.bfloat16, 132, 72),    # no tile shorter than 64 frames: 7 tiles
    (300, 501, torch.bfloat16, 132, 501),  # more streams than block slots: one tile
    (1, 40, torch.float32, 132, 40),      # a sequence shorter than a tile
])
def test_cascade_tile_plan(batch, time, dtype, sms, want):
    tile = se_res2.cascade_tile(batch, time, dtype, sms)
    assert tile == want
    tiles = -(-time // tile)
    assert tiles * tile >= time > (tiles - 1) * tile


@pytest.mark.parametrize("stage", [0, 1, 4, 7, 9])
def test_staged_equals_the_tiled_cascade_at_the_plans_tile(stage):
    """The stage mode's plain version against z1 followed by the cascade split
    at the tile the wrapper would hand the kernel for these streams."""
    rng = np.random.default_rng(stage)
    chans, hidden = (GROUPS + 1) * WIDTH, 8
    n = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    mk = lambda *s: n(*s, scale=0.5 / np.sqrt(s[-2]))
    params = (
        mk(chans, chans), 0.1 * n(chans), 1 + 0.1 * n(chans), 0.1 * n(chans),
        n(GROUPS, 3, WIDTH, WIDTH, scale=0.5 / np.sqrt(3 * WIDTH)),
        0.1 * n(GROUPS, WIDTH), 1 + 0.1 * n(GROUPS, WIDTH), 0.1 * n(GROUPS, WIDTH),
        mk(chans, chans), 0.1 * n(chans), 1 + 0.1 * n(chans), 0.1 * n(chans),
        mk(chans, hidden), 0.1 * n(hidden), mk(hidden, chans), 0.1 * n(chans),
    )
    x = n(2, 150, chans)
    tile = se_res2.cascade_tile(2, 150, x.dtype, 132)
    assert tile == 75
    want = se_res2.se_res2_staged(x, params, 3, stage)
    z1 = se_res2.se_res2_staged(x, params, 3, 0)
    got = z1 if stage == 0 else se_res2.cascade_tiled(z1, *params[4:8], 3, min(GROUPS, stage), tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
