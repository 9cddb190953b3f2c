"""The split route of the LSTM sweep (f32 stream, H = 128 and 64) outside its
CUDA kernel, held on the CPU: the layout ``pack_w_hh`` makes for it, the sum
order ``packed_gates`` replays (each part one chain over its own half of k,
then the other half; the parts added as a balanced tree in part order), and
a whole sweep walked in that order. The kernel itself is held against the
plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from diart_tpu_torch.ops.lstm_sweep import (
    _split_walk,
    lstm_sweep_reference,
    lstm_sweep_tm,
    pack_w_hh,
    packed_gates,
    unpack_w_hh,
)

WIDTHS = [64, 128]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _w_hh(seed, hidden):
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.3 / np.sqrt(hidden / 8), size=(2, 4 * hidden, hidden))
    return torch.from_numpy(w.astype(np.float32))


def _h(seed, batch, hidden):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, size=(2, batch, hidden)).astype(np.float32))


def _replay(w_hh, h):
    """The split route's product written out unit by unit and part by part:
    part p of unit j chains over k = 8p .. 8p+7 of the half its block computes
    (the first half for units 0..63, the second for 64..127 when H = 128),
    then of the other half; the parts' sums meet as a balanced tree."""
    hidden = w_hh.shape[-1]
    parts, half = hidden // 16, hidden // 2
    out = torch.empty(2, h.shape[1], 4 * hidden)
    for j in range(hidden):
        own = j // 64
        rows = w_hh[:, [g * hidden + j for g in range(4)]]  # (2, 4, H)
        sums = []
        for p in range(parts):
            acc = torch.zeros(2, h.shape[1], 4)
            for hf in (own, 1 - own):
                for e in range(8):
                    k = hf * half + 8 * p + e
                    acc = acc + rows[:, None, :, k] * h[:, :, k, None]
            sums.append(acc)
        while len(sums) > 1:
            sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
        for g in range(4):
            out[:, :, g * hidden + j] = sums[0][:, :, g]
    return out


@pytest.mark.parametrize("hidden", WIDTHS)
def test_packed_gates_is_the_part_by_part_replay(hidden):
    w_hh, h = _w_hh(hidden, hidden), _h(hidden + 1, 3, hidden)
    packed = pack_w_hh(w_hh, torch.float32)
    assert packed.route == "split"
    got = packed_gates(packed, h)
    assert torch.equal(got, _replay(w_hh, h))
    # the same products as the plain h @ w_hh^T, summed in another order
    want = torch.bmm(h.double(), w_hh.double().transpose(1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_split_pack_gives_a_thread_four_gate_rows_own_half_first(hidden):
    """Thread tid = 32 warp + (H / 16) u + p of block ``rank`` holds, in its
    16 float4s, gate r // 4 of unit 64 rank + warp (512 / H) + u over k = 8p
    .. 8p+7 of its block's half (r % 4 < 2), then of the other half."""
    parts = hidden // 16
    # w_hh[d][row][k] = 1000 row + k: each entry names its row and column
    rows = torch.arange(4 * hidden, dtype=torch.float32).view(1, -1, 1) * 1000
    w = (rows + torch.arange(hidden, dtype=torch.float32)).expand(2, -1, -1)
    data = pack_w_hh(w, torch.float32).data
    for rank in range(hidden // 64):
        for tid in (0, 5, 33, 4 * hidden - 1):
            warp, u, p = tid // 32, (tid % 32) // parts, tid % parts
            unit = 64 * rank + warp * (512 // hidden) + u
            for r in range(16):
                g, slot = r // 4, (r % 4) // 2
                half = slot ^ rank
                k0 = half * hidden // 2 + 8 * p + 4 * (r % 2)
                want = torch.tensor([1000.0 * (g * hidden + unit) + k0 + c for c in range(4)])
                assert torch.equal(data[1, rank, r, tid], want)


# The whole sweep in the split route's order against the plain version:
# the same f32 recurrence with its sums in another order; 1e-5 holds the
# reordering's few ulps through the steps (outputs in [-1, 1]).
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("time,batch", [(21, 3), (16, 5)])
def test_split_walk_matches_the_plain_sweep(time, batch, hidden):
    rng = np.random.default_rng(time * 10 + batch)
    proj = torch.from_numpy(rng.normal(size=(time, 2, batch, 4 * hidden)).astype(np.float32))
    w_hh = _w_hh(batch, hidden)
    got = _split_walk(proj, pack_w_hh(w_hh, torch.float32))
    want = lstm_sweep_reference(proj, w_hh)
    assert got.shape == (time, 2, batch, hidden) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_raw_and_packed_w_hh_agree(hidden):
    rng = np.random.default_rng(hidden)
    proj = torch.from_numpy(rng.normal(size=(7, 2, 3, 4 * hidden)).astype(np.float32))
    w_hh = _w_hh(2, hidden)
    packed = pack_w_hh(w_hh, torch.float32)
    assert torch.equal(unpack_w_hh(packed), w_hh)
    assert torch.equal(lstm_sweep_tm(proj, operands=packed), lstm_sweep_tm(proj, w_hh))
