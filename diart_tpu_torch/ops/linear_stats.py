"""Fused final-TDNN projection + weighted statistics.

Counterpart of ``diart_tpu/ops/pallas_stats.py``'s ``fused_linear_stats``,
equal to its ``linear_stats_reference``. On a CUDA tensor it launches the
hand-written kernel ``csrc/linear_stats.cu``, which never writes the
(B, T, C) projection to memory; on a CPU tensor it runs the plain einsum
version below. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_linear_stats", "linear_stats_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPEAKERS = 8  # the kernel's register tiles are instantiated for S <= 8


def linear_stats_reference(x, w, b, scale, shift, weights, negative_slope: float = 0.01):
    """Plain version: ``(s1, s2)`` weighted first/second moments of
    ``scale * leaky(x @ w + b) + shift``. ``w`` is rounded to ``x``'s dtype
    (as the TPU kernel's wrapper does) and every product accumulates in f32.

    x: (B, T, C_in); w: (C_in, C); b/scale/shift: (C,); weights: (B, S, T)
    -> s1, s2: (B, S, C) float32.
    """
    y = torch.matmul(x.float(), w.to(x.dtype).float()) + b.float()
    y = torch.where(y >= 0, y, negative_slope * y)
    z = y * scale.float() + shift.float()
    wt = weights.float()
    s1 = torch.einsum("btd,bst->bsd", z, wt)
    s2 = torch.einsum("btd,bst->bsd", z * z, wt)
    return s1, s2


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_stats_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.linear_stats_launch.restype = i
    lib.linear_stats_uses_mma.argtypes = [i, i]
    lib.linear_stats_uses_mma.restype = i


def uses_tensor_cores(c_in: int, dtype: torch.dtype) -> bool:
    """Whether a call with this input width and dtype runs the tensor-core
    kernel (bf16 X, C_in % 8 == 0) rather than the FMA one."""
    lib = _build.library("linear_stats", _signature)
    return bool(lib.linear_stats_uses_mma(c_in, _DTYPES[dtype]))


def fused_linear_stats(x, w, b, scale, shift, weights, negative_slope: float = 0.01):
    """Weighted moments of ``scale * leaky(x @ w + b) + shift`` without
    materializing the projection.

    x: (B, T, C_in) f32 or bf16; w: (C_in, C); b, scale, shift: (C,) (the
    folded inference batch-norm affine); weights: (B, S, T) non-negative.
    Returns (s1, s2), each (B, S, C) float32.
    """
    if x.dim() != 3 or w.dim() != 2 or weights.dim() != 3:
        raise ValueError("x must be (B, T, C_in), w (C_in, C), weights (B, S, T)")
    batch, time, c_in = x.shape
    channels = w.shape[1]
    if w.shape[0] != c_in:
        raise ValueError(f"w has {w.shape[0]} input rows; x has {c_in} channels")
    if weights.shape[0] != batch or weights.shape[2] != time:
        raise ValueError(f"weights {tuple(weights.shape)} do not match x {tuple(x.shape)}")
    for v in (b, scale, shift):
        if tuple(v.shape) != (channels,):
            raise ValueError(f"bias/scale/shift must be ({channels},); got {tuple(v.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if any(t.device != x.device for t in (w, b, scale, shift, weights)):
        raise ValueError("all inputs must be on the same device")
    if x.device.type == "cpu":
        return linear_stats_reference(x, w, b, scale, shift, weights, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    speakers = weights.shape[1]
    if not 1 <= speakers <= MAX_SPEAKERS:
        raise ValueError(f"the stats kernel takes 1..{MAX_SPEAKERS} speakers; got {speakers}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    lib = _build.library("linear_stats", _signature)
    # W in X's dtype; bf16 rows are padded to a multiple of 8 channels so the
    # tensor-core kernel's 16-byte loads stay aligned
    ldw = channels if x.dtype == torch.float32 else -(-channels // 8) * 8
    wc = torch.nn.functional.pad(w.to(x.dtype), (0, ldw - channels)).contiguous()
    f32 = lambda v: v.float().contiguous()
    bc, ac, cc, wt = f32(b), f32(scale), f32(shift), f32(weights)
    s1 = torch.empty(batch, speakers, channels, device=x.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        err = lib.linear_stats_launch(
            x.data_ptr(), wc.data_ptr(), bc.data_ptr(), ac.data_ptr(), cc.data_ptr(),
            wt.data_ptr(), s1.data_ptr(), s2.data_ptr(), batch, time, c_in, channels,
            ldw, speakers, _DTYPES[x.dtype], float(negative_slope), _build.stream_handle(x.device),
        )
    _build.check(lib, "linear_stats", err)
    fused_linear_stats.launches += 1
    return s1, s2


fused_linear_stats.launches = 0
