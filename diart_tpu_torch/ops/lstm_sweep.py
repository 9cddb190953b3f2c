"""Bidirectional LSTM sweep over a pre-projected gate stream.

Counterpart of ``diart_tpu/ops/pallas_lstm.py``'s ``lstm_sweep_tm``: the
time-major sweep over UNREVERSED projections, equal to its ``_tm_reference``.
On a CUDA tensor it launches the hand-written kernel ``csrc/lstm_sweep.cu``
(one persistent launch per call); on a CPU tensor it runs the plain
step-by-step version below. There is no fallback between the two. Under
autograd on a CUDA tensor the call is :class:`SweepFunction`: the kernel
forward, autograd through the plain version backward (as the JAX
package's ``custom_vjp``); the packed operand is cut off from autograd, so a
trained ``w_hh`` goes in raw.

The kernel reads ``w_hh`` in a layout of its own: :func:`pack_w_hh` makes it
(:class:`SweepWeights`) and ``lstm_sweep_tm`` takes either the raw
``(2, 4H, H)`` tensor or the packed operand, so a model with fixed weights
packs once instead of on every call. Two layouts, by the kernel's route:

* ``"mma"`` (bf16 stream, H = 128 or 64): the ``mma.sync``
  m16n8k16 A fragments of ``w_hh``, ``[d][warp][tile][k tile][lane][reg][2]``.
  Warp ``w`` owns hidden units ``8w .. 8w+7``; row ``r`` of its tile ``m`` is
  gate ``2m + r // 8`` of unit ``8w + r % 8``, so one thread's accumulators
  are the four gates of one unit. Lane ``l`` holds, in register ``q``, rows
  ``l // 4 + 8 (q % 2)`` and columns ``2 (l % 4) + 8 (q // 2) + {0, 1}`` of
  each 16 x 16 tile. The kernel keeps these registers for the whole sweep.
* ``"fma"`` (f32 stream, or any other H): ``[d][k][j][gate]``, so thread j
  reads its four gate weights for one k as one vector.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from . import _build
from ._grad import plain_vjp, refuse_trained_operands, wants_grad

__all__ = [
    "SweepFunction",
    "SweepWeights",
    "launch_plan",
    "lstm_sweep_reference",
    "lstm_sweep_tm",
    "pack_w_hh",
    "packed_gates",
    "unpack_w_hh",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "mma": 1}
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
    lib.lstm_sweep_plan.argtypes = [i, i, i, i, ip, ip, ip, ip]
    lib.lstm_sweep_plan.restype = None


def launch_plan(batch: int, hidden: int, dtype: torch.dtype, device) -> dict:
    """The kernel's launch plan for a sweep of this size on ``device``: the
    route (``"mma"``: tensor cores, ``"fma"``), batch rows per block, k
    groups per block (FMA route) and where w_hh lives during the sweep."""
    lib = _build.library("lstm_sweep", _signature)
    route, bt, ks, home = (ctypes.c_int() for _ in range(4))
    lib.lstm_sweep_plan(batch, hidden, _DTYPES[dtype], _build.num_sms(device), route, bt, ks, home)
    return {"route": "mma" if route.value else "fma", "rows_per_block": bt.value,
            "k_groups": ks.value, "w_hh_in": _W_HOME[home.value]}


class SweepWeights(NamedTuple):
    """``w_hh`` laid out for the kernel's ``route`` (see the module's note),
    in the stream dtype."""

    data: torch.Tensor
    hidden: int
    route: str


def _route(hidden: int, dtype: torch.dtype) -> str:
    """The kernel's route for this size (the rule of ``csrc/lstm_sweep.cu``)."""
    return "mma" if dtype == torch.bfloat16 and hidden in (64, 128) else "fma"


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


def pack_w_hh(w_hh: torch.Tensor, dtype: torch.dtype) -> SweepWeights:
    """Lay ``w_hh`` (2, 4H, H) out for a stream of ``dtype``."""
    hidden = w_hh.shape[-1]
    if tuple(w_hh.shape) != (2, 4 * hidden, hidden):
        raise ValueError(f"w_hh must be (2, 4H, H); got {tuple(w_hh.shape)}")
    route = _route(hidden, dtype)
    w = w_hh.to(dtype)
    if route == "mma":
        row, col = _fragment_index(hidden, w.device)
        data = w[:, row, col].contiguous()
    else:
        data = w.view(2, 4, hidden, hidden).permute(0, 3, 2, 1).contiguous()
    return SweepWeights(data, hidden, route)


def unpack_w_hh(packed: SweepWeights) -> torch.Tensor:
    """The (2, 4H, H) ``w_hh`` (in the stream dtype) a pack was made from."""
    hidden = packed.hidden
    if packed.route == "mma":
        row, col = _fragment_index(hidden, packed.data.device)
        w = torch.empty(2, 4 * hidden, hidden, dtype=packed.data.dtype, device=packed.data.device)
        w[:, row, col] = packed.data
        return w
    return packed.data.permute(0, 3, 2, 1).reshape(2, 4 * hidden, hidden)


def packed_gates(packed: SweepWeights, h: torch.Tensor) -> torch.Tensor:
    """One step's recurrent product ``h @ w_hh^T`` computed from the packed
    operand the way the kernel walks it: h (2, B, H) in the stream dtype ->
    (2, B, 4H) f32. On the ``"mma"`` route each warp's two 16-row tiles are
    rebuilt from the fragments, multiplied k tile by k tile, and the even
    and the odd k tiles summed as two chains that meet at the end."""
    hidden, hf = packed.hidden, h.float()
    if packed.route == "fma":  # [d][k][j][gate]
        return torch.einsum("dbk,dkjg->dbgj", hf, packed.data.float()).reshape(2, -1, 4 * hidden)
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


class SweepFunction(torch.autograd.Function):
    """The sweep with a gradient (``jax.custom_vjp`` of ``pallas_lstm.py``):
    the forward launches the kernel on CUDA tensors (the plain version on
    CPU tensors) with ``packed``, or ``w_hh`` packed for the call; the
    backward is autograd through :func:`lstm_sweep_reference` on the saved
    ``proj_t`` and ``w_hh``."""

    @staticmethod
    def forward(ctx, proj_t, w_hh, packed: Optional[SweepWeights] = None):
        ctx.save_for_backward(proj_t, w_hh)
        if proj_t.device.type == "cpu":
            return lstm_sweep_reference(proj_t, w_hh)
        return _launch(proj_t, packed if packed is not None else pack_w_hh(w_hh, proj_t.dtype))

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(ctx, lstm_sweep_reference, (grad,)), None)


def lstm_sweep_tm(proj_t: torch.Tensor, w_hh: Union[torch.Tensor, SweepWeights]) -> torch.Tensor:
    """Time-major bidirectional sweep.

    proj_t: (T, 2, B, 4H) input projections incl. bias, both directions in
        natural time order; f32 or bf16 (the stream dtype).
    w_hh: (2, 4H, H) recurrent weights (gate order i, f, g, o), used in the
        stream dtype; or their :class:`SweepWeights` from :func:`pack_w_hh`.

    Returns (T, 2, B, H) hidden states in the stream dtype, both directions
    in natural time order.
    """
    if proj_t.dim() != 4 or proj_t.shape[1] != 2 or proj_t.shape[-1] % 4:
        raise ValueError(f"proj_t must be (T, 2, B, 4H); got {tuple(proj_t.shape)}")
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    if proj_t.dtype not in _DTYPES:
        raise TypeError(f"stream dtype must be float32 or bfloat16; got {proj_t.dtype}")
    packed = w_hh if isinstance(w_hh, SweepWeights) else None
    if packed is None:
        if tuple(w_hh.shape) != (2, gates4, hidden):
            raise ValueError(f"w_hh must be (2, {gates4}, {hidden}); got {tuple(w_hh.shape)}")
    elif packed.hidden != hidden or packed.data.dtype != proj_t.dtype:
        raise ValueError(
            f"w_hh was packed for H={packed.hidden}, {packed.data.dtype}; "
            f"the stream has H={hidden}, {proj_t.dtype}"
        )
    if (w_hh.data if packed else w_hh).device != proj_t.device:
        raise ValueError("proj_t and w_hh must be on the same device")
    if packed is not None:
        refuse_trained_operands(packed, "the packed w_hh (SweepWeights)")
    if proj_t.device.type == "cpu":
        return lstm_sweep_reference(proj_t, unpack_w_hh(packed) if packed else w_hh)
    if proj_t.device.type != "cuda":
        raise ValueError(f"unsupported device {proj_t.device}")
    if not proj_t.is_contiguous():
        raise ValueError("proj_t must be contiguous")
    if hidden > KERNEL_MAX_HIDDEN:
        raise ValueError(f"the sweep kernel takes H <= {KERNEL_MAX_HIDDEN}; got {hidden}")
    if wants_grad(proj_t, None if packed else w_hh):
        return SweepFunction.apply(proj_t, unpack_w_hh(packed) if packed else w_hh, packed)
    return _launch(proj_t, packed if packed is not None else pack_w_hh(w_hh, proj_t.dtype))


lstm_sweep_tm.launches = 0
