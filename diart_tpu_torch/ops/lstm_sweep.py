"""Bidirectional LSTM sweep over a pre-projected gate stream.

Counterpart of ``diart_tpu/ops/pallas_lstm.py``'s ``lstm_sweep_tm``: the
time-major sweep over UNREVERSED projections, equal to its ``_tm_reference``.
On a CUDA tensor it launches the hand-written kernel ``csrc/lstm_sweep.cu``
(one persistent launch per call); on a CPU tensor it runs the plain
step-by-step version below. There is no fallback between the two. Under
autograd the call is :class:`SweepFunction`, whose backward is
:func:`lstm_sweep_backward`: on a CUDA tensor the hand-written kernel
``csrc/lstm_sweep_bwd.cu`` between two bulk products, on a CPU tensor its
plain version :func:`lstm_sweep_backward_reference`. Both compute the
gradient of :func:`lstm_sweep_reference` (what the JAX package's
``custom_vjp`` takes of its ``lax.scan`` reference), with its rounding
points. The packed operand is cut off from autograd, so a trained ``w_hh``
goes in raw.

The forward kernel has three routes, chosen by the stream dtype and H
(:func:`_route` states the rule of ``csrc/lstm_sweep.cu``;
:func:`launch_plan` reports the plan), and reads ``w_hh`` in a layout of
each route's own: :func:`pack_w_hh` makes it (:class:`SweepWeights`) and
``lstm_sweep_tm`` takes the raw ``(2, 4H, H)`` tensor or, as ``operands=``,
the packed one, so a model with fixed weights packs once instead of on
every call.
:func:`packed_gates` replays each route's recurrent product in its sum
order. The layouts:

* ``"mma"`` (bf16 stream, H = 128 or 64): the ``mma.sync``
  m16n8k16 A fragments of ``w_hh``, ``[d][warp][tile][k tile][lane][reg][2]``.
  Warp ``w`` owns hidden units ``8w .. 8w+7``; row ``r`` of its tile ``m`` is
  gate ``2m + r // 8`` of unit ``8w + r % 8``, so one thread's accumulators
  are the four gates of one unit. Lane ``l`` holds, in register ``q``, rows
  ``l // 4 + 8 (q % 2)`` and columns ``2 (l % 4) + 8 (q // 2) + {0, 1}`` of
  each 16 x 16 tile. The kernel keeps these registers for the whole sweep.
* ``"split"`` (f32 stream, H = 128 or 64): w_hh held in registers for
  the whole sweep, as f32; a block owns 64 hidden units and all four gate
  rows of each over every k, so H = 128 takes a cluster of 2 blocks, which
  send each other their units' new h through distributed shared memory.
  The H / 16 threads of a unit (its "parts", lanes of one warp) each hold
  its four gate rows over k = 8p .. 8p+7 of each half of the k range, the
  block's own half (slot 0) first: ``(2, C, 16, 4H, 4)`` f32 (C = H / 64
  blocks a cluster), ``[d][rank][4 g + 2 slot + e // 4][tid][e % 4] =
  w_hh[d][g H + j][(slot ^ rank) H / 2 + 8 p + e]`` for thread ``tid = 32
  warp + (H / 16) u + p`` of unit ``j = 64 rank + warp (512 / H) + u``. Each
  part's sum is one chain over its own half's eight k, then the other
  half's; the parts' sums are added as a balanced tree in part order.
* ``"fma"`` (every other H, either dtype): ``[d][k][j][gate]``, so thread j
  reads its four gate weights for one k as one vector.

The backward kernel has two routes, chosen by H (:func:`backward_plan`
reports them; :func:`pack_backward_w` lays ``w_hh`` out for each, and
:func:`backward_product` replays each one's product in plain PyTorch):

* ``"split"`` (H = 128 or 64, both dtypes): W = r(w_hh) held in registers
  for the whole walk, as f32; a block holds 64 units (columns) and all 4H
  rows of them, so H = 128 takes a cluster of 2 blocks, which send each
  other their units' da through distributed shared memory. With the rows
  in unit-major order (4 u + gate), thread ``16 p + q`` holds rows
  ``16p .. 16p+15`` of columns ``4q .. 4q+3``; each unit's 4H-row sum is
  split over the 4H / 16 parts (every warp of the block), each part one
  FMA chain of 16 rows, and the parts are added as a balanced tree in part
  order before the one rounding to the stream dtype.
* ``"column"`` (every other H <= 256): one thread a unit walks the 4H rows
  of its column, W in shared memory where it fits and through L2 beyond.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from ._grad import refuse_trained_operands, wants_grad
from ._numerics import true_f32

__all__ = [
    "SweepFunction",
    "SweepWeights",
    "backward_max_clusters",
    "backward_plan",
    "backward_product",
    "launch_plan",
    "lstm_sweep_backward",
    "lstm_sweep_backward_reference",
    "lstm_sweep_reference",
    "lstm_sweep_tm",
    "max_clusters",
    "pack_backward_w",
    "pack_w_hh",
    "packed_gates",
    "unpack_w_hh",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "mma": 1, "split": 2}
_W_HOME = ("global memory (L2)", "shared memory", "registers")
KERNEL_MAX_HIDDEN = 256


def lstm_sweep_reference(proj_t: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version: (T, 2, B, 4H) -> (T, 2, B, H), direction 1 walking
    t = T-1 .. 0. h and c are f32; h is rounded to the stream dtype before it
    multiplies w_hh (cast to the stream dtype), and the output is stored in
    the stream dtype — the numerics of the TPU kernel."""
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    dt = proj_t.dtype
    w = w_hh.to(dt).float()  # (2, 4H, H)
    h = torch.zeros(2, batch, hidden, device=proj_t.device)
    c = torch.zeros_like(h)
    fwd, bwd = [], []  # stacked at the end, so autograd keeps no copy of the output a step
    for t in range(time):
        xt = torch.stack([proj_t[t, 0], proj_t[time - 1 - t, 1]]).float()
        gates = xt + torch.bmm(h.to(dt).float(), w.transpose(1, 2))
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        fwd.append(h[0].to(dt))
        bwd.append(h[1].to(dt))
    return torch.stack([torch.stack(fwd), torch.stack(bwd[::-1])], dim=1)


def _signature(lib: ctypes.CDLL) -> None:
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.lstm_sweep_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.lstm_sweep_launch.restype = i
    lib.lstm_sweep_plan.argtypes = [i, i, i, i, ip]
    lib.lstm_sweep_plan.restype = None
    lib.lstm_sweep_max_clusters.argtypes = [i, i, ip]
    lib.lstm_sweep_max_clusters.restype = i


def launch_plan(batch: int, hidden: int, dtype: torch.dtype, device) -> dict:
    """The kernel's launch plan for a sweep of this size on ``device``, as
    the kernel's library computes it: the route (``"mma"``: tensor cores,
    ``"split"``, ``"fma"``), batch rows per block, k groups per block (FMA
    route), where w_hh lives during the sweep, blocks a cluster, blocks,
    threads a block and the threads that add to one unit's sum."""
    lib = _build.library("lstm_sweep", _signature)
    f = (ctypes.c_int * 8)()
    lib.lstm_sweep_plan(batch, hidden, _DTYPES[dtype], _build.num_sms(device), f)
    return {"route": {v: k for k, v in _ROUTES.items()}[f[0]], "rows_per_block": f[1], "k_groups": f[2],
            "w_hh_in": _W_HOME[f[3]], "cluster": f[4], "blocks": f[5], "threads": f[6], "threads_per_unit": f[7]}


def max_clusters(batch: int, device) -> int:
    """How many clusters of the split route at H = 128 the card holds at
    once (``cudaOccupancyMaxActiveClusters``), for reports."""
    lib = _build.library("lstm_sweep", _signature)
    n = ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.lstm_sweep_max_clusters(batch, _build.num_sms(device), n)
    _build.check(lib, "lstm_sweep", err)
    return n.value


class SweepWeights(NamedTuple):
    """``w_hh`` laid out for the kernel's ``route`` (``"mma"``, ``"split"``
    or ``"fma"``; see the module's note), in the stream dtype."""

    data: torch.Tensor
    hidden: int
    route: str


def _route(hidden: int, dtype: torch.dtype) -> str:
    """The kernel's route for this size (the rule of ``csrc/lstm_sweep.cu``
    ``route_of``)."""
    if hidden not in (64, 128):
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "split"


@functools.lru_cache(maxsize=None)
def _fragment_index(hidden: int, device: torch.device):
    """(row, column) of ``w_hh[d]`` held at [warp][tile][k tile][lane][reg][2],
    as index tensors on ``device``."""
    ar = torch.arange
    warp, tile, ktile = ar(hidden // 8).view(-1, 1, 1, 1, 1, 1), ar(2).view(-1, 1, 1, 1, 1), ar(hidden // 16).view(-1, 1, 1, 1)
    lane, reg, pair = ar(32).view(-1, 1, 1), ar(4).view(-1, 1), ar(2)
    row = (2 * tile + reg % 2) * hidden + 8 * warp + lane // 4
    col = 16 * ktile + 2 * (lane % 4) + 8 * (reg // 2) + pair
    shape = (hidden // 8, 2, hidden // 16, 32, 4, 2)
    return row.expand(shape).to(device), col.expand(shape).to(device)


_SPLIT_UNITS = 64  # hidden units a block holds on the split routes (forward and backward)


@functools.lru_cache(maxsize=None)
def _split_index(hidden: int, device: torch.device):
    """(row, column) of ``w_hh[d]`` held at the split layout's
    [rank][4 g + 2 slot + e // 4][tid][e % 4], as index tensors on ``device``."""
    parts = hidden // 16
    ar = torch.arange
    rank, r = ar(hidden // _SPLIT_UNITS).view(-1, 1, 1, 1), ar(16).view(-1, 1, 1)
    tid, c = ar(4 * hidden).view(-1, 1), ar(4)
    lane = tid % 32
    unit = _SPLIT_UNITS * rank + (tid // 32) * (32 // parts) + lane // parts
    g, slot, e = r // 4, (r % 4) // 2, (r % 2) * 4 + c
    row = g * hidden + unit
    col = (slot ^ rank) * (hidden // 2) + 8 * (lane % parts) + e
    shape = (hidden // _SPLIT_UNITS, 16, 4 * hidden, 4)
    return row.expand(shape).to(device), col.expand(shape).to(device)


def _layout_index(route: str, hidden: int, device: torch.device):
    return (_fragment_index if route == "mma" else _split_index)(hidden, device)


def _pack_fma(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The FMA route's layout: (2, H, H, 4) in ``dtype``, ``[d][k][j][gate]``."""
    hidden = w_hh.shape[-1]
    return w_hh.to(dtype).view(2, 4, hidden, hidden).permute(0, 3, 2, 1).contiguous()


def pack_w_hh(w_hh: torch.Tensor, dtype: torch.dtype) -> SweepWeights:
    """Lay ``w_hh`` (2, 4H, H) out for a stream of ``dtype``."""
    hidden = w_hh.shape[-1]
    if tuple(w_hh.shape) != (2, 4 * hidden, hidden):
        raise ValueError(f"w_hh must be (2, 4H, H); got {tuple(w_hh.shape)}")
    route = _route(hidden, dtype)
    if route == "fma":
        return SweepWeights(_pack_fma(w_hh, dtype), hidden, route)
    w = w_hh.to(dtype)
    row, col = _layout_index(route, hidden, w.device)
    return SweepWeights(w[:, row, col].contiguous(), hidden, route)


def unpack_w_hh(packed: SweepWeights) -> torch.Tensor:
    """The (2, 4H, H) ``w_hh`` (in the stream dtype) a pack was made from."""
    hidden = packed.hidden
    if packed.route == "fma":
        return packed.data.permute(0, 3, 2, 1).reshape(2, 4 * hidden, hidden)
    row, col = _layout_index(packed.route, hidden, packed.data.device)
    w = torch.empty(2, 4 * hidden, hidden, dtype=packed.data.dtype, device=packed.data.device)
    w[:, row, col] = packed.data
    return w


@functools.lru_cache(maxsize=None)
def _split_k(hidden: int, device: torch.device) -> torch.Tensor:
    """k of [unit j][part p][slot][e] on the split route: the unit's own
    half of the k range (slot 0, the half its block computes) first."""
    parts, ar = hidden // 16, torch.arange
    rank = (ar(hidden) // _SPLIT_UNITS).view(-1, 1, 1, 1)
    k = (ar(2).view(-1, 1) ^ rank) * (hidden // 2) + 8 * ar(parts).view(-1, 1, 1) + ar(8)
    return k.to(device)


def packed_gates(packed: SweepWeights, h: torch.Tensor) -> torch.Tensor:
    """One step's recurrent product ``h @ w_hh^T`` computed from the packed
    operand the way the kernel walks it: h (2, B, H) in the stream dtype ->
    (2, B, 4H) f32. On the ``"mma"`` route each warp's two 16-row tiles are
    rebuilt from the fragments, multiplied k tile by k tile, and the even
    and the odd k tiles summed as two chains that meet at the end. On the
    ``"split"`` route each part p of unit j is one chain over its sixteen
    k (its own half's eight, then the other half's), and the parts' sums
    are added as a balanced tree in part order (the kernel's chains are
    fused multiply-adds; these round the product and the sum apart)."""
    hidden, hf = packed.hidden, h.float()
    if packed.route == "fma":  # [d][k][j][gate]
        return torch.einsum("dbk,dkjg->dbgj", hf, packed.data.float()).reshape(2, -1, 4 * hidden)
    if packed.route == "split":
        parts = hidden // 16
        # [d][rank][g][slot][e // 4][warp][u][p][e % 4] -> [d][j][p][g][slot][e]
        wk = packed.data.float().view(2, hidden // _SPLIT_UNITS, 4, 2, 2, hidden // 8, 32 // parts, parts, 4)
        wk = wk.permute(0, 1, 5, 6, 7, 2, 3, 4, 8).reshape(2, hidden, parts, 4, 2, 8)
        hk = hf[:, :, _split_k(hidden, h.device)]  # (2, B, j, p, slot, e)
        prod = wk[:, None] * hk[:, :, :, :, None]  # (2, B, j, p, g, slot, e)
        acc = torch.zeros_like(prod[..., 0, 0])
        for slot in range(2):
            for e in range(8):
                acc = acc + prod[..., slot, e]
        while acc.shape[3] > 1:  # the balanced tree over the parts, in part order
            acc = acc[:, :, :, 0::2] + acc[:, :, :, 1::2]
        return acc[:, :, :, 0].transpose(2, 3).reshape(2, -1, 4 * hidden)
    warps, ktiles = hidden // 8, hidden // 16
    lane, reg, pair = torch.arange(32).view(-1, 1, 1), torch.arange(4).view(-1, 1), torch.arange(2)
    r = (lane // 4 + 8 * (reg % 2)).expand(32, 4, 2)
    k = (2 * (lane % 4) + 8 * (reg // 2) + pair).expand(32, 4, 2)
    tiles = torch.zeros(2, warps, 2, ktiles, 16, 16, device=h.device)
    tiles[..., r.to(h.device), k.to(h.device)] = packed.data.float()
    chains = [0.0, 0.0]
    for kt in range(ktiles):  # (d, warp, tile, 16 rows, B)
        hk = hf[:, :, 16 * kt:16 * (kt + 1)].transpose(1, 2)[:, None, None]
        chains[kt % 2] = chains[kt % 2] + torch.matmul(tiles[:, :, :, kt], hk)
    acc = chains[0] + chains[1]
    # row r of tile m of warp w is gate 2m + r // 8 of unit 8w + r % 8
    acc = acc.view(2, warps, 2, 2, 8, -1).permute(0, 5, 2, 3, 1, 4)
    return acc.reshape(2, -1, 4 * hidden)


def _split_walk(proj_t: torch.Tensor, packed: SweepWeights) -> torch.Tensor:
    """The whole f32 sweep in the split route's order (for tests): each
    step's product by :func:`packed_gates`, then the gate stream added to it
    and the cell updated as the kernel does. (T, 2, B, 4H) -> (T, 2, B, H)."""
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    h = torch.zeros(2, batch, hidden, device=proj_t.device)
    c = torch.zeros_like(h)
    out = torch.empty(time, 2, batch, hidden, device=proj_t.device)
    for t in range(time):
        xt = torch.stack([proj_t[t, 0], proj_t[time - 1 - t, 1]]).float()
        i, f, g, o = (xt + packed_gates(packed, h)).split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t, 0], out[time - 1 - t, 1] = h[0], h[1]
    return out


def _launch(proj_t: torch.Tensor, packed: SweepWeights) -> torch.Tensor:
    """Launch the kernel on CUDA tensors."""
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    lib = _build.library("lstm_sweep", _signature)
    dev = proj_t.device
    if proj_t.data_ptr() % 16:  # the kernel copies the stream in 16-byte pieces
        proj_t = proj_t.clone()
    out = torch.empty(time, 2, batch, hidden, dtype=proj_t.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.lstm_sweep_launch(
            proj_t.data_ptr(), packed.data.data_ptr(), out.data_ptr(), time, batch, hidden,
            _DTYPES[proj_t.dtype], _ROUTES[packed.route], _build.num_sms(dev),
            _build.stream_handle(dev),
        )
    _build.check(lib, "lstm_sweep", err)
    lstm_sweep_tm.launches += 1
    return out


# --------------------------------------------------------------------- #
# The backward. Notation: r rounds to the stream dtype (the identity for
# f32), W = float(r(w_hh[d])). Direction d visits step s at time t = s
# (d = 0) or T - 1 - s (d = 1); the forward's step s computes the
# pre-activation a_s = float(proj[t, d]) + r(h_{s-1}) W^T, and r(h_{s-1}) is
# the stored ``out`` at the previous visited time (0 at s = 0). Walking s
# down from T - 1, with e_T = 0 and dc_T = 0:
#   dh_s = float(dout[t, d]) + e_{s+1},  e_s = float(r(da_s W))
#   dc_s = dh_s o (1 - tanh^2 c_s) + dc_{s+1} f_{s+1}
#   da_s = [dc_s g i(1-i), dc_s c_{s-1} f(1-f), dc_s i (1-g^2), dh_s tanh c_s o(1-o)]
# then dproj[t, d] = r(da_s) and dw_hh[d] = r(sum_s da_s^T r(h_{s-1})),
# summed in f32 and returned in w_hh's dtype: what autograd gives through
# lstm_sweep_reference (its casts round the same terms). The recurrent
# products r(h_{s-1}) W^T of every step and the weight gradient are one
# batched product each, outside the recurrence; what is left, the walk
# itself, is the kernel (its plain version: _bptt_reference).
def _prev_hidden(out: torch.Tensor) -> torch.Tensor:
    """(T, 2, B, H) stored outputs -> (2, T, B, H) f32: r(h) at each
    direction's previous visited time, 0 at its first step."""
    hr = out.new_zeros((2,) + tuple(out.shape[:1] + out.shape[2:]), dtype=torch.float32)
    hr[0, 1:] = out[:-1, 0]
    hr[1, :-1] = out[1:, 1]
    return hr


def _recurrent_products(hr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """r(h_{s-1}) W^T of every step: (2, T, B, H) f32 -> (2, T, B, 4H) f32."""
    two, time, batch, hidden = hr.shape
    return torch.bmm(hr.view(2, time * batch, hidden), w.transpose(1, 2)).view(2, time, batch, 4 * hidden)


def _bptt_reference(proj_t: torch.Tensor, pre: torch.Tensor, dout: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: the walk back through time.

    proj_t (T, 2, B, 4H) and dout (T, 2, B, H) in the stream dtype, pre
    (2, T, B, 4H) f32 (:func:`_recurrent_products`), w_hh (2, 4H, H) raw ->
    da (2, T, B, 4H) f32, the gradient of every pre-activation."""
    hidden = proj_t.shape[-1] // 4
    dt = proj_t.dtype
    w = w_hh.to(dt).float()
    steps = lambda x: torch.stack([x[0], x[1].flip(0)])  # natural time <-> step order
    a = steps(proj_t.float().transpose(0, 1) + pre)  # (2, T, B, 4H), step order
    g_out = steps(dout.float().transpose(0, 1))
    i, f, g, o = (torch.sigmoid(a[..., :hidden]), torch.sigmoid(a[..., hidden:2 * hidden]),
                  torch.tanh(a[..., 2 * hidden:3 * hidden]), torch.sigmoid(a[..., 3 * hidden:]))
    c = [torch.zeros_like(g_out[:, 0])]
    for s in range(a.shape[1]):  # the forward's cell states, c[s + 1] = c_s
        c.append(f[:, s] * c[s] + i[:, s] * g[:, s])
    e = dc_next = f_next = torch.zeros_like(c[0])
    da = [None] * a.shape[1]
    for s in reversed(range(a.shape[1])):
        tc = torch.tanh(c[s + 1])
        dh = g_out[:, s] + e
        dc = dh * o[:, s] * (1 - tc * tc) + dc_next * f_next
        da[s] = torch.cat([
            dc * g[:, s] * (1 - i[:, s]) * i[:, s],
            dc * c[s] * (1 - f[:, s]) * f[:, s],
            dc * i[:, s] * (1 - g[:, s] * g[:, s]),
            dh * tc * (1 - o[:, s]) * o[:, s],
        ], dim=-1)
        e = torch.bmm(da[s], w).to(dt).float()
        dc_next, f_next = dc, f[:, s]
    return steps(torch.stack(da, dim=1))


def _gradients(da: torch.Tensor, hr: torch.Tensor, dt: torch.dtype, w_dtype: torch.dtype):
    """(dproj (T, 2, B, 4H) in ``dt``, dw_hh (2, 4H, H) in ``w_dtype``)
    from da (2, T, B, 4H) and r(h_{s-1}) (2, T, B, H), both f32."""
    two, time, batch, gates4 = da.shape
    dproj = torch.empty(time, 2, batch, gates4, dtype=dt, device=da.device)
    dproj.copy_(da.transpose(0, 1))
    dw = torch.bmm(da.view(2, time * batch, gates4).transpose(1, 2), hr.view(2, time * batch, -1))
    return dproj, dw.to(dt).to(w_dtype)


def _backward(proj_t, w_hh, out, dout, walk):
    """The batched products around ``walk`` (the kernel or its plain
    version), in true f32."""
    hr = _prev_hidden(out)
    with true_f32(proj_t.device):
        pre = _recurrent_products(hr, w_hh.to(proj_t.dtype).float())
        da = walk(proj_t, pre, dout.contiguous(), w_hh)
        return _gradients(da, hr, proj_t.dtype, w_hh.dtype)


def lstm_sweep_backward_reference(proj_t: torch.Tensor, w_hh: torch.Tensor, out: torch.Tensor,
                                  dout: torch.Tensor):
    """Plain version of the sweep's backward: (dproj_t, dw_hh), the gradient
    of :func:`lstm_sweep_reference` at (proj_t, w_hh), whose output was
    ``out``, against the cotangent ``dout``; an explicit walk back through
    time with the forward's rounding points (see the note above)."""
    return _backward(proj_t, w_hh, out, dout, _bptt_reference)


def _bwd_signature(lib: ctypes.CDLL) -> None:
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    for name in ("lstm_sweep_bwd_launch", "lstm_sweep_bwd_phase_a_launch"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        getattr(lib, name).restype = i
    lib.lstm_sweep_bwd_plan.argtypes = [i, i, i, i, ip]
    lib.lstm_sweep_bwd_plan.restype = None
    lib.lstm_sweep_bwd_max_clusters.argtypes = [i, i, i, ip]
    lib.lstm_sweep_bwd_max_clusters.restype = i


_SPLIT_ROWS, _SPLIT_COLS = 16, 4  # the backward's split route: rows, columns of W a thread


def _backward_route(hidden: int) -> str:
    """The backward kernel's route for this width (the rule of
    ``csrc/lstm_sweep_bwd.cu``)."""
    return "split" if hidden in (64, 128) else "column"


def backward_plan(batch: int, hidden: int, dtype: torch.dtype, device) -> dict:
    """The backward kernel's launch plan for a sweep of this size on
    ``device``, as the kernel's library computes it: the route
    (``"split"`` / ``"column"``), blocks a cluster, batch rows a block,
    threads a block, blocks, the warps that add to each unit's sum, units
    (columns of W) a block, W's rows in registers, in shared memory and
    read through L2 (of ``w_rows`` = 4H), and where W lives."""
    lib = _build.library("lstm_sweep_bwd", _bwd_signature)
    f = (ctypes.c_int * 10)()
    lib.lstm_sweep_bwd_plan(batch, hidden, _DTYPES[dtype], _build.num_sms(device), f)
    plan = dict(route="split" if f[0] else "column", cluster=f[1], rows_per_block=f[2], threads=f[3],
                blocks=f[4], warps_per_unit=f[5], units_per_block=f[6], w_rows=4 * hidden,
                w_rows_in_registers=f[7], w_rows_in_shared=f[8], w_rows_in_l2=f[9])
    homes = [n for n, k in (("registers", 7), ("shared memory", 8), ("L2", 9)) if f[k]]
    plan["w_in"] = " + ".join(homes)
    return plan


def backward_max_clusters(batch: int, dtype: torch.dtype, device) -> int:
    """How many clusters of the split route at H = 128 the card holds at
    once (``cudaOccupancyMaxActiveClusters``), for reports."""
    lib = _build.library("lstm_sweep_bwd", _bwd_signature)
    n = ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.lstm_sweep_bwd_max_clusters(batch, _DTYPES[dtype], _build.num_sms(device), n)
    _build.check(lib, "lstm_sweep_bwd", err)
    return n.value


def _pack_column(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The column route's layout: (2, H, H, 4) in ``dtype``,
    ``[d][m // 4][j][m % 4] = w_hh[d][m][j]``."""
    hidden = w_hh.shape[-1]
    return w_hh.to(dtype).view(2, hidden, 4, hidden).permute(0, 1, 3, 2).contiguous()


def pack_backward_w(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w_hh`` (2, 4H, H) laid out for the backward kernel's route.

    ``"split"``: (2, C, 16, 4H, 4) f32 (C = H / 64 blocks a cluster),
    ``[d][k][r][16 p + q][c] = float(r(w_hh))[d][g H + u][64 k + 4 q + c]``
    for row ``16 p + r = 4 u + g`` in unit-major order (gate g of unit u):
    thread ``16 p + q`` of block k loads its 16 x 4 values as 16 coalesced
    16-byte loads, and the thread of unit u stores its four gates' da as
    one 16-byte vector. ``"column"``: (2, H, H, 4) in ``dtype``,
    ``[d][m // 4][j][m % 4] = w_hh[d][m][j]``, so the thread of unit j
    reads four rows m of its column in one load."""
    hidden = w_hh.shape[-1]
    if _backward_route(hidden) == "column":
        return _pack_column(w_hh, dtype)
    w = w_hh.to(dtype).float().view(2, 4, hidden, hidden).transpose(1, 2)  # [d][u][g][col]
    # rows 16p + r (= 4u + g), columns 64k + 4q + c
    w = w.reshape(2, hidden // 4, _SPLIT_ROWS, hidden // _SPLIT_UNITS, _SPLIT_UNITS // _SPLIT_COLS, _SPLIT_COLS)
    return w.permute(0, 3, 2, 1, 4, 5).reshape(2, hidden // _SPLIT_UNITS, _SPLIT_ROWS, 4 * hidden,
                                               _SPLIT_COLS).contiguous()


def backward_product(wp: torch.Tensor, da: torch.Tensor, hidden: int) -> torch.Tensor:
    """``da W`` (da (2, B, 4H) f32 in gate-major order -> (2, B, H) f32,
    before the rounding to the stream dtype) computed from the packed
    operand ``wp`` in the order the kernel's route adds it. ``"split"``:
    with the rows in unit-major order, in each part p (rows 16p ..
    16p+15: units 4p .. 4p+3) one chain over its 16 rows, then the parts
    added as a balanced tree in part order; every cluster block adds all 4H
    rows of its own 64 columns. ``"column"``: four chains over m % 4, each
    over m // 4 in order, summed (0 + 1) + (2 + 3)."""
    two, batch, gates4 = da.shape
    if _backward_route(hidden) == "column":
        chains = [da.new_zeros(2, batch, hidden) for _ in range(4)]
        wf = wp.float()  # [d][m // 4][j][m % 4]
        for m4 in range(hidden):
            for k in range(4):
                chains[k] = chains[k] + da[:, :, 4 * m4 + k, None] * wf[:, None, m4, :, k]
        return (chains[0] + chains[1]) + (chains[2] + chains[3])
    blocks, parts = hidden // _SPLIT_UNITS, hidden // 4
    # [d][k][r][p][q][c] -> W's (unit-major) rows 16p + r of columns 64k + 4q + c
    wf = wp.float().view(2, blocks, _SPLIT_ROWS, parts, _SPLIT_UNITS // _SPLIT_COLS, _SPLIT_COLS)
    wf = wf.permute(0, 3, 2, 1, 4, 5).reshape(2, parts, _SPLIT_ROWS, hidden)  # [d][p][r][j]
    x = da.view(2, batch, 4, hidden).transpose(2, 3).reshape(2, batch, parts, _SPLIT_ROWS)
    acc = da.new_zeros(2, batch, parts, hidden)
    for r in range(_SPLIT_ROWS):  # one chain a part, column and batch row
        acc = acc + x[:, :, :, r, None] * wf[:, None, :, r, :]
    while acc.shape[2] > 1:  # the balanced tree over the parts, in part order
        acc = acc[:, :, 0::2] + acc[:, :, 1::2]
    return acc[:, :, 0]


def _backward_launcher(name: str, counted: bool):
    def launch(proj_t: torch.Tensor, pre: torch.Tensor, dout: torch.Tensor, wp: torch.Tensor):
        time, _, batch, gates4 = proj_t.shape
        hidden = gates4 // 4
        lib = _build.library("lstm_sweep_bwd", _bwd_signature)
        dev = proj_t.device
        # phase A's scratch: (2, T, B, 2, H) f32 (the column route uses its first half)
        cells = torch.empty(2, time, batch, 2, hidden, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = getattr(lib, name)(
                proj_t.data_ptr(), pre.data_ptr(), dout.data_ptr(), wp.data_ptr(), cells.data_ptr(),
                time, batch, hidden, _DTYPES[proj_t.dtype], _build.num_sms(dev), _build.stream_handle(dev),
            )
        _build.check(lib, "lstm_sweep_bwd", err)
        if counted:
            lstm_sweep_backward.launches += 1
        return pre
    return launch


_launch_backward = _backward_launcher("lstm_sweep_bwd_launch", True)
_launch_backward.__doc__ = """Launch the backward kernel on CUDA tensors (``wp`` from
:func:`pack_backward_w`): ``pre`` is overwritten with da and returned."""
# the split route's phase A alone (H = 128; the kernel's template stops
# there), to time the kernel's phase split: never on the path, not counted
_launch_phase_a = _backward_launcher("lstm_sweep_bwd_phase_a_launch", False)


def lstm_sweep_backward(proj_t: torch.Tensor, w_hh: torch.Tensor, out: torch.Tensor, dout: torch.Tensor):
    """The sweep's backward: (dproj_t, dw_hh) as
    :func:`lstm_sweep_backward_reference` gives them. On CUDA tensors the
    recurrent products of every step and the weight gradient are batched
    products (in true f32) around ONE launch of the backward kernel
    ``csrc/lstm_sweep_bwd.cu``; on CPU tensors, the plain version.

    proj_t (T, 2, B, 4H) and out, dout (T, 2, B, H) in the stream dtype;
    w_hh (2, 4H, H) raw."""
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    if proj_t.dtype not in _DTYPES or out.dtype != proj_t.dtype or dout.dtype != proj_t.dtype:
        raise TypeError(f"stream dtype must be float32 or bfloat16 for proj_t, out and dout; got "
                        f"{proj_t.dtype}, {out.dtype}, {dout.dtype}")
    if (tuple(w_hh.shape) != (2, gates4, hidden) or tuple(out.shape) != (time, 2, batch, hidden)
            or tuple(dout.shape) != tuple(out.shape)):
        raise ValueError(f"shapes: proj_t {tuple(proj_t.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)}")
    if len({t.device for t in (proj_t, w_hh, out, dout)}) != 1:
        raise ValueError("proj_t, w_hh, out and dout must be on the same device")
    if proj_t.device.type == "cpu":
        return lstm_sweep_backward_reference(proj_t, w_hh, out, dout)
    if proj_t.device.type != "cuda":
        raise ValueError(f"unsupported device {proj_t.device}")
    if hidden > KERNEL_MAX_HIDDEN:
        raise ValueError(f"the backward kernel takes H <= {KERNEL_MAX_HIDDEN}; got {hidden}")
    if not proj_t.is_contiguous():
        raise ValueError("proj_t must be contiguous")
    return _backward(proj_t, w_hh, out, dout,
                     lambda p, pre, d, w: _launch_backward(p, pre, d, pack_backward_w(w, p.dtype)))


lstm_sweep_backward.launches = 0


class SweepFunction(torch.autograd.Function):
    """The sweep with a gradient (``jax.custom_vjp`` of ``pallas_lstm.py``):
    the forward launches the kernel on CUDA tensors (the plain version on
    CPU tensors) with ``packed``, or ``w_hh`` packed for the call, and saves
    its output; the backward is :func:`lstm_sweep_backward` (the backward
    kernel on CUDA tensors, its plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, proj_t, w_hh, packed: Optional[SweepWeights] = None):
        if proj_t.device.type == "cpu":
            out = lstm_sweep_reference(proj_t, w_hh)
        else:
            out = _launch(proj_t, packed if packed is not None else pack_w_hh(w_hh, proj_t.dtype))
        ctx.save_for_backward(proj_t, w_hh, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        proj_t, w_hh, out = ctx.saved_tensors
        dproj, dw = lstm_sweep_backward(proj_t, w_hh, out, grad)
        return (dproj if ctx.needs_input_grad[0] else None, dw if ctx.needs_input_grad[1] else None, None)


def lstm_sweep_tm(proj_t: torch.Tensor, w_hh: Optional[torch.Tensor] = None,
                  operands: Optional[SweepWeights] = None) -> torch.Tensor:
    """Time-major bidirectional sweep.

    proj_t: (T, 2, B, 4H) input projections incl. bias, both directions in
        natural time order; f32 or bf16 (the stream dtype).
    w_hh: (2, 4H, H) recurrent weights (gate order i, f, g, o), used in the
        stream dtype.
    operands: ``pack_w_hh(w_hh, proj_t.dtype)``, where the caller holds it;
        it carries ``w_hh``, which is then left out.

    Returns (T, 2, B, H) hidden states in the stream dtype, both directions
    in natural time order.
    """
    refuse_trained_operands(operands)
    if proj_t.dim() != 4 or proj_t.shape[1] != 2 or proj_t.shape[-1] % 4:
        raise ValueError(f"proj_t must be (T, 2, B, 4H); got {tuple(proj_t.shape)}")
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    if proj_t.dtype not in _DTYPES:
        raise TypeError(f"stream dtype must be float32 or bfloat16; got {proj_t.dtype}")
    if (w_hh is None) == (operands is None):
        raise ValueError("give w_hh or its packed operands: one of the two")
    if operands is None:
        if tuple(w_hh.shape) != (2, gates4, hidden):
            raise ValueError(f"w_hh must be (2, {gates4}, {hidden}); got {tuple(w_hh.shape)}")
    elif operands.hidden != hidden or operands.data.dtype != proj_t.dtype:
        raise ValueError(
            f"w_hh was packed for H={operands.hidden}, {operands.data.dtype}; "
            f"the stream has H={hidden}, {proj_t.dtype}"
        )
    if (w_hh if operands is None else operands.data).device != proj_t.device:
        raise ValueError("proj_t and w_hh must be on the same device")
    if proj_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {proj_t.device}")
    if proj_t.device.type == "cuda":
        if not proj_t.is_contiguous():
            raise ValueError("proj_t must be contiguous")
        if hidden > KERNEL_MAX_HIDDEN:
            raise ValueError(f"the sweep kernel takes H <= {KERNEL_MAX_HIDDEN}; got {hidden}")
    if wants_grad(proj_t, w_hh):
        return SweepFunction.apply(proj_t, unpack_w_hh(operands) if w_hh is None else w_hh, operands)
    if proj_t.device.type == "cpu":
        return lstm_sweep_reference(proj_t, unpack_w_hh(operands) if w_hh is None else w_hh)
    return _launch(proj_t, operands if operands is not None else pack_w_hh(w_hh, proj_t.dtype))


lstm_sweep_tm.launches = 0
