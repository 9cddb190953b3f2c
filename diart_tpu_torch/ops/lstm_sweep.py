"""Bidirectional LSTM sweep over a pre-projected gate stream.

Counterpart of ``diart_tpu/ops/pallas_lstm.py``'s ``lstm_sweep_tm``: the
time-major sweep over UNREVERSED projections, equal to its ``_tm_reference``.
On a CUDA tensor it launches the hand-written kernel ``csrc/lstm_sweep.cu``
(one persistent launch per call); on a CPU tensor it runs the plain
step-by-step version below. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lstm_sweep_tm", "lstm_sweep_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    out = torch.empty(time, 2, batch, hidden, dtype=dt, device=proj_t.device)
    for t in range(time):
        xt = torch.stack([proj_t[t, 0], proj_t[time - 1 - t, 1]]).float()
        gates = xt + torch.bmm(h.to(dt).float(), w.transpose(1, 2))
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t, 0] = h[0].to(dt)
        out[time - 1 - t, 1] = h[1].to(dt)
    return out


def _signature(lib: ctypes.CDLL) -> None:
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.lstm_sweep_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.lstm_sweep_launch.restype = i
    lib.lstm_sweep_plan.argtypes = [i, i, i, i, ip, ip, ip]
    lib.lstm_sweep_plan.restype = None


def launch_plan(batch: int, hidden: int, dtype: torch.dtype, device) -> dict:
    """The kernel's launch plan for a sweep of this size on ``device``:
    batch rows per block, k groups per block, and whether w_hh is held in
    shared memory."""
    lib = _build.library("lstm_sweep", _signature)
    bt, ks, w_smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.lstm_sweep_plan(batch, hidden, _DTYPES[dtype], _build.num_sms(device), bt, ks, w_smem)
    return {"rows_per_block": bt.value, "k_groups": ks.value, "w_hh_in_smem": bool(w_smem.value)}


def _pack(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2, 4H, H) [d, g*H + j, k] -> (2, H, H, 4) [d, k, j, g]: thread j of
    the kernel reads its four gate weights for one k as one vector."""
    hidden = w_hh.shape[-1]
    return w_hh.to(dtype).view(2, 4, hidden, hidden).permute(0, 3, 2, 1).contiguous()


def lstm_sweep_tm(proj_t: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Time-major bidirectional sweep.

    proj_t: (T, 2, B, 4H) input projections incl. bias, both directions in
        natural time order; f32 or bf16 (the stream dtype).
    w_hh: (2, 4H, H) recurrent weights (gate order i, f, g, o); used in the
        stream dtype.

    Returns (T, 2, B, H) hidden states in the stream dtype, both directions
    in natural time order.
    """
    if proj_t.dim() != 4 or proj_t.shape[1] != 2 or proj_t.shape[-1] % 4:
        raise ValueError(f"proj_t must be (T, 2, B, 4H); got {tuple(proj_t.shape)}")
    time, _, batch, gates4 = proj_t.shape
    hidden = gates4 // 4
    if tuple(w_hh.shape) != (2, gates4, hidden):
        raise ValueError(f"w_hh must be (2, {gates4}, {hidden}); got {tuple(w_hh.shape)}")
    if proj_t.dtype not in _DTYPES:
        raise TypeError(f"stream dtype must be float32 or bfloat16; got {proj_t.dtype}")
    if w_hh.device != proj_t.device:
        raise ValueError("proj_t and w_hh must be on the same device")
    if proj_t.device.type == "cpu":
        return lstm_sweep_reference(proj_t, w_hh)
    if proj_t.device.type != "cuda":
        raise ValueError(f"unsupported device {proj_t.device}")
    if not proj_t.is_contiguous():
        raise ValueError("proj_t must be contiguous")
    if hidden > 256:
        raise ValueError(f"the sweep kernel takes H <= 256; got {hidden}")
    lib = _build.library("lstm_sweep", _signature)
    dev = proj_t.device
    wp = _pack(w_hh, proj_t.dtype)
    out = torch.empty(time, 2, batch, hidden, dtype=proj_t.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.lstm_sweep_launch(
            proj_t.data_ptr(), wp.data_ptr(), out.data_ptr(), time, batch, hidden,
            _DTYPES[proj_t.dtype], _build.num_sms(dev), _build.stream_handle(dev),
        )
    _build.check(lib, "lstm_sweep", err)
    lstm_sweep_tm.launches += 1
    return out


lstm_sweep_tm.launches = 0
