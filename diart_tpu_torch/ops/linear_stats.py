"""Fused final-TDNN projection + weighted statistics.

Counterpart of ``diart_tpu/ops/pallas_stats.py``'s ``fused_linear_stats``,
equal to its ``linear_stats_reference``. On a CUDA tensor it launches the
hand-written kernel ``csrc/linear_stats.cu``, which never writes the
(B, T, C) projection to memory; on a CPU tensor it runs the plain einsum
version below. There is no fallback between the two. Under autograd on a
CUDA tensor the call is :class:`LinearStatsFunction`: the kernel forward,
autograd through the plain version backward (as the JAX package's
``custom_vjp``); prepared operands are cut off from autograd, so trained
parameters go in raw.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from ._grad import plain_vjp, refuse_trained_operands, wants_grad

__all__ = [
    "LinearStatsFunction",
    "StatsOperands",
    "fused_linear_stats",
    "launch_plan",
    "linear_stats_reference",
    "prepare_stats_operands",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPEAKERS = 8  # the kernel's register tiles are instantiated for S <= 8
WGMMA_CHANNELS, WGMMA_FRAMES = 128, 144  # the tensor-core kernel's tiles


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


class StatsOperands(NamedTuple):
    """The head's parameters laid out for the kernel, made once per model
    (:func:`prepare_stats_operands`): ``w`` (C_in, ldw) in X's dtype with
    zero columns from C to ``ldw`` (C rounded up to 8 in bf16, so the
    kernel's 16-byte copies stay aligned), and the bias and the folded batch
    norm (``scale``, ``shift``) as contiguous f32 (C,)."""

    w: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    channels: int


def prepare_stats_operands(w, b, scale, shift, dtype: torch.dtype) -> StatsOperands:
    """Lay ``w`` (C_in, C), ``b``, ``scale`` and ``shift`` (C,) out for a
    call with X in ``dtype``."""
    if w.dim() != 2:
        raise ValueError(f"w must be (C_in, C); got {tuple(w.shape)}")
    channels = w.shape[1]
    for v in (b, scale, shift):
        if tuple(v.shape) != (channels,):
            raise ValueError(f"bias/scale/shift must be ({channels},); got {tuple(v.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {dtype}")
    ldw = channels if dtype == torch.float32 else -(-channels // 8) * 8
    f32 = lambda v: v.float().contiguous()
    wc = torch.nn.functional.pad(w.to(dtype), (0, ldw - channels)).contiguous()
    return StatsOperands(wc, f32(b), f32(scale), f32(shift), channels)


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_stats_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.linear_stats_launch.restype = i
    lib.linear_stats_wgmma_smem.argtypes = [i, i, i, i]
    lib.linear_stats_wgmma_smem.restype = ctypes.c_longlong


def launch_plan(batch: int, time: int, channels: int, smem: int, sms: int) -> dict:
    """The kernel's launch plan, given the shared memory of its tensor-core
    block as ``csrc/linear_stats.cu`` reports it for the call
    (``linear_stats_wgmma_smem``: 0 where the call takes the FMA route):
    the route (``"wgmma"``: bf16 X with C_in % 8 == 0 whose tiles fit a
    block; ``"fma"``: everything else), the channel and frame tiles, the
    streams each block walks and the grid. On the tensor cores the streams
    of each channel tile are packed onto about one block a multiprocessor,
    so a block copies W once for several streams. Pure arithmetic."""
    if smem:
        tiles_c = -(-channels // WGMMA_CHANNELS)
        per = -(-batch // max(1, sms // tiles_c))
        return dict(route="wgmma", channel_tile=WGMMA_CHANNELS, frame_tile=WGMMA_FRAMES,
                    frame_tiles=-(-time // WGMMA_FRAMES), streams_per_block=per,
                    grid=(tiles_c, -(-batch // per)), smem=smem)
    return dict(route="fma", channel_tile=64, frame_tile=64, frame_tiles=-(-time // 64),
                streams_per_block=1, grid=(-(-channels // 64), batch), smem=0)


def _check(x, w, b, scale, shift, weights) -> None:
    if x.dim() != 3 or w.dim() != 2 or weights is None or weights.dim() != 3:
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


def _plan(x, ops: StatsOperands, speakers: int) -> dict:
    """:func:`launch_plan` of a call on CUDA tensors."""
    batch, time, c_in = x.shape
    lib = _build.library("linear_stats", _signature)
    smem = lib.linear_stats_wgmma_smem(c_in, ops.w.shape[1], speakers, _DTYPES[x.dtype])
    return launch_plan(batch, time, ops.channels, smem, _build.num_sms(x.device))


def _launch(x, ops: StatsOperands, weights, negative_slope: float):
    """Launch the kernel on CUDA tensors."""
    batch, time, c_in = x.shape
    speakers, channels = weights.shape[1], ops.channels
    if not 1 <= speakers <= MAX_SPEAKERS:
        raise ValueError(f"the stats kernel takes 1..{MAX_SPEAKERS} speakers; got {speakers}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:  # the tensor-core kernel copies X in 16-byte pieces
        x = x.clone()
    lib = _build.library("linear_stats", _signature)
    plan = _plan(x, ops, speakers)
    wt = weights.float().contiguous()
    s1 = torch.empty(batch, speakers, channels, device=x.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        err = lib.linear_stats_launch(
            x.data_ptr(), ops.w.data_ptr(), ops.bias.data_ptr(), ops.scale.data_ptr(),
            ops.shift.data_ptr(), wt.data_ptr(), s1.data_ptr(), s2.data_ptr(), batch, time, c_in,
            channels, ops.w.shape[1], speakers, _DTYPES[x.dtype], float(negative_slope),
            plan["streams_per_block"], _build.stream_handle(x.device),
        )
    _build.check(lib, "linear_stats", err)
    fused_linear_stats.launches += 1
    return s1, s2


class LinearStatsFunction(torch.autograd.Function):
    """The fused head with a gradient (``jax.custom_vjp`` of
    ``pallas_stats.py``): the forward launches the kernel on CUDA tensors
    (the plain version on CPU tensors) with ``ops``, or the raw parameters
    prepared for the call; the backward is autograd through
    :func:`linear_stats_reference` on the saved raw inputs."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, weights, ops: Optional[StatsOperands] = None,
                negative_slope: float = 0.01):
        ctx.save_for_backward(x, w, b, scale, shift, weights)
        ctx.negative_slope = negative_slope
        if x.device.type == "cpu":
            return linear_stats_reference(x, w, b, scale, shift, weights, negative_slope)
        if ops is None:
            ops = prepare_stats_operands(w, b, scale, shift, x.dtype)
        return _launch(x, ops, weights, negative_slope)

    @staticmethod
    def backward(ctx, g1, g2):
        ref = lambda *args: linear_stats_reference(*args, ctx.negative_slope)
        return (*plain_vjp(ctx, ref, (g1, g2)), None, None)


def fused_linear_stats(x, w, b=None, scale=None, shift=None, weights=None,
                       negative_slope: float = 0.01):
    """Weighted moments of ``scale * leaky(x @ w + b) + shift`` without
    materializing the projection.

    x: (B, T, C_in) f32 or bf16; w: (C_in, C), with b, scale, shift (C,)
    (the folded inference batch-norm affine) — or, in place of all four,
    their :class:`StatsOperands` from :func:`prepare_stats_operands`;
    weights: (B, S, T) non-negative. Returns (s1, s2), each (B, S, C)
    float32.
    """
    ops = w if isinstance(w, StatsOperands) else None
    if ops is None:
        if any(v is None for v in (b, scale, shift)):
            raise ValueError("raw operands need b, scale and shift")
        raw = (w, b, scale, shift)
    else:
        if any(v is not None for v in (b, scale, shift)):
            raise ValueError("prepared operands carry the bias and the affine")
        if ops.w.dtype != x.dtype:
            raise ValueError(f"the operands were prepared for {ops.w.dtype}; x is {x.dtype}")
        refuse_trained_operands(ops, "the prepared stats operands (StatsOperands)")
        raw = (ops.w[:, :ops.channels], ops.bias, ops.scale, ops.shift)
    _check(x, *raw, weights)
    if x.device.type == "cpu":
        return linear_stats_reference(x, *raw, weights, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if wants_grad(x, *raw, weights):
        return LinearStatsFunction.apply(x, *raw, weights, ops, negative_slope)
    if ops is None:
        ops = prepare_stats_operands(w, b, scale, shift, x.dtype)
    return _launch(x, ops, weights, negative_slope)


fused_linear_stats.launches = 0
