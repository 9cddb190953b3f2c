"""Fused channel-attention weighted statistics.

Counterpart of ``diart_tpu/ops/pallas_attn_stats.py``'s
``fused_attentive_stats``, equal to its ``attentive_stats_reference``. On
a CUDA tensor it launches the hand-written kernel ``csrc/attn_stats.cu``,
which never writes the (B, T, C) attention logits or products to memory;
on a CPU tensor it runs the plain version below. There is no fallback
between the two. Under autograd on a CUDA tensor the call is
:class:`AttnStatsFunction`: the kernel forward, autograd through the plain
version backward (as the JAX package's ``custom_vjp``); prepared operands
are cut off from autograd, so trained parameters go in raw.

The kernel computes the logits on the TF32 tensor cores at f32 accuracy
(3xTF32: each operand split into a TF32 ``hi`` and ``lo``,
:func:`split_tf32`), so it reads W2^T already split:
:func:`prepare_attn_operands` makes that once per model
(:class:`AttnOperands`), and ``fused_attentive_stats`` takes the raw
``w2, b2`` or, as ``operands=``, the prepared operands.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from ._grad import plain_vjp, refuse_trained_operands, wants_grad
from ._numerics import split_tf32

__all__ = [
    "AttnOperands",
    "AttnStatsFunction",
    "attentive_stats_reference",
    "fused_attentive_stats",
    "launch_plan",
    "prepare_attn_operands",
    "split_tf32",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPEAKERS = 8  # the kernel's register accumulators are instantiated for S <= 8
MAX_H = 128  # the kernel holds W2^T's rows in registers for H <= 128
CHANNELS, FRAMES, SLICE_H = 128, 64, 32  # the kernel's channel tile, frame tile, H slice


def attentive_stats_reference(x, hidden, w2, b2, weights):
    """Plain version: ``(den, s1, s2)``, each (B, S, C) f32, with
    ``alpha = softmax_t(hidden @ w2 + b2)`` per channel and
    ``den = sum_t w alpha``, ``s1 = sum_t w alpha x``,
    ``s2 = sum_t w alpha x^2``; everything in f32.

    x: (B, T, C) f32 or bf16; hidden: (B, T, H); w2: (H, C); b2: (C,);
    weights: (B, S, T) non-negative."""
    return _stats_from_logits(x, torch.matmul(hidden.float(), w2.float()) + b2.float(), weights)


def _stats_from_logits(x, logits, weights):
    """The plain version's softmax and moments from (B, T, C) f32 logits."""
    alpha = torch.softmax(logits, dim=1)
    xf = x.float()
    wt = weights.float()
    ax = alpha * xf
    den = torch.einsum("btc,bst->bsc", alpha, wt)
    s1 = torch.einsum("btc,bst->bsc", ax, wt)
    s2 = torch.einsum("btc,bst->bsc", ax * xf, wt)
    return den, s1, s2


class AttnOperands(NamedTuple):
    """The attention scores' parameters laid out for the kernel, made once
    per model (:func:`prepare_attn_operands`): ``hi`` and ``lo``, W2^T
    (C, Hp) split for TF32 (:func:`split_tf32`), Hp = H rounded up to 32
    with zero columns beyond H; ``w2`` (H, C) and ``b2`` (C,) in f32, which
    the plain version reads."""

    hi: torch.Tensor
    lo: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def prepare_attn_operands(w2: torch.Tensor, b2: torch.Tensor) -> AttnOperands:
    """Lay ``w2`` (H, C) and ``b2`` (C,) out for the kernel."""
    if w2.dim() != 2 or tuple(b2.shape) != (w2.shape[1],):
        raise ValueError(f"w2 must be (H, C) and b2 (C,); got {tuple(w2.shape)}, {tuple(b2.shape)}")
    w2f = w2.float().contiguous()
    hdim = w2.shape[0]
    wt = torch.nn.functional.pad(w2f.t(), (0, -(-hdim // SLICE_H) * SLICE_H - hdim))
    hi, lo = split_tf32(wt)
    return AttnOperands(hi, lo, w2f, b2.float().contiguous())


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attn_stats_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.attn_stats_launch.restype = i
    lib.attn_stats_smem.argtypes = [i, i, i]
    lib.attn_stats_smem.restype = ctypes.c_longlong


def launch_plan(batch: int, time: int, channels: int, smem: int, sms: int) -> dict:
    """The kernel's launch plan, given the shared memory of a block as
    ``csrc/attn_stats.cu`` reports it for the call (``attn_stats_smem``):
    128-channel tiles, 64-frame tiles, the streams each block walks and the
    grid. The streams of each channel tile are packed onto about one block
    a multiprocessor, so a block reads W2^T once for several streams. Pure
    arithmetic."""
    tiles_c = -(-channels // CHANNELS)
    per = -(-batch // max(1, sms // tiles_c))
    return dict(route="tf32x3", channel_tile=CHANNELS, frame_tile=FRAMES,
                frame_tiles=-(-time // FRAMES), streams_per_block=per,
                grid=(tiles_c, -(-batch // per)), smem=smem)


def _x_copy_bytes(x: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes) that every row of x is aligned to."""
    row = x.shape[-1] * x.element_size()
    for v in (16, 8, 4):
        if row % v == 0 and x.data_ptr() % v == 0:
            return v
    raise ValueError(f"the attention-stats kernel copies x in 4-byte pieces: {x.dtype} x needs "
                     f"rows of a multiple of 4 bytes; C={x.shape[-1]}")


def _plan(x, hidden, speakers: int) -> dict:
    """:func:`launch_plan` of a call on CUDA tensors."""
    batch, time, channels = x.shape
    lib = _build.library("attn_stats", _signature)
    smem = lib.attn_stats_smem(hidden.shape[2], speakers, _DTYPES[x.dtype])
    return launch_plan(batch, time, channels, smem, _build.num_sms(x.device))


def _launch(x, hidden, ops: AttnOperands, weights):
    """Launch the kernel on CUDA tensors."""
    batch, time, channels = x.shape
    hdim, speakers = hidden.shape[2], weights.shape[1]
    if not 1 <= speakers <= MAX_SPEAKERS:
        raise ValueError(f"the attention-stats kernel takes 1..{MAX_SPEAKERS} speakers; got {speakers}")
    if hdim % 8 or hdim > MAX_H:
        raise ValueError(f"the attention-stats kernel takes H % 8 == 0 and H <= {MAX_H}; got H={hdim}")
    lib = _build.library("attn_stats", _signature)
    plan = _plan(x, hidden, speakers)
    xc = x.contiguous()
    hc = hidden.float().contiguous()
    if hc.data_ptr() % 16:  # the kernel's TMA map of hidden needs a 16-byte-aligned base
        hc = hc.clone()
    wt = weights.float().contiguous()
    den = torch.empty(batch, speakers, channels, device=x.device)
    s1, s2 = torch.empty_like(den), torch.empty_like(den)
    with torch.cuda.device(x.device):
        err = lib.attn_stats_launch(
            xc.data_ptr(), hc.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(), ops.b2.data_ptr(),
            wt.data_ptr(), den.data_ptr(), s1.data_ptr(), s2.data_ptr(), batch, time, channels,
            hdim, speakers, _DTYPES[x.dtype], plan["streams_per_block"], _x_copy_bytes(xc),
            _build.stream_handle(x.device),
        )
    _build.check(lib, "attn_stats", err)
    fused_attentive_stats.launches += 1
    return den, s1, s2


class AttnStatsFunction(torch.autograd.Function):
    """The attentive statistics with a gradient (``jax.custom_vjp`` of
    ``pallas_attn_stats.py``): the forward launches the kernel on CUDA
    tensors (the plain version on CPU tensors) with ``ops``, or ``w2, b2``
    prepared for the call; the backward is autograd through
    :func:`attentive_stats_reference` on the saved raw inputs."""

    @staticmethod
    def forward(ctx, x, hidden, w2, b2, weights, ops: Optional[AttnOperands] = None):
        ctx.save_for_backward(x, hidden, w2, b2, weights)
        if x.device.type == "cpu":
            return attentive_stats_reference(x, hidden, w2, b2, weights)
        return _launch(x, hidden, ops if ops is not None else prepare_attn_operands(w2, b2), weights)

    @staticmethod
    def backward(ctx, g_den, g_s1, g_s2):
        return (*plain_vjp(ctx, attentive_stats_reference, (g_den, g_s1, g_s2)), None)


def fused_attentive_stats(x, hidden, w2=None, b2=None, weights=None,
                          operands: Optional[AttnOperands] = None):
    """``(den, s1, s2)`` of channel-attentive weighted pooling without
    materializing the (B, T, C) logits or products.

    x: (B, T, C) f32 or bf16; hidden: (B, T, H) (read as f32, as the TPU
    wrapper casts it); w2: (H, C) with b2 (C,); weights: (B, S, T).
    ``operands`` is ``prepare_attn_operands(w2, b2)``, where the caller
    holds it; it carries both, which are then left out. Returns three
    (B, S, C) float32 tensors.
    """
    refuse_trained_operands(operands)
    if operands is None:
        if w2 is None or b2 is None:
            raise ValueError("give w2 and b2, or their prepared operands")
    elif w2 is not None or b2 is not None:
        raise ValueError("the prepared operands carry w2 and b2")
    w2r, b2r = (w2, b2) if operands is None else (operands.w2, operands.b2)
    if x.dim() != 3 or hidden.dim() != 3 or w2r.dim() != 2 or weights is None or weights.dim() != 3:
        raise ValueError("x must be (B, T, C), hidden (B, T, H), w2 (H, C), weights (B, S, T)")
    batch, time, channels = x.shape
    bottleneck = hidden.shape[2]
    if hidden.shape[:2] != (batch, time):
        raise ValueError(f"hidden {tuple(hidden.shape)} does not match x {tuple(x.shape)}")
    if tuple(w2r.shape) != (bottleneck, channels) or tuple(b2r.shape) != (channels,):
        raise ValueError(f"w2 must be ({bottleneck}, {channels}) and b2 ({channels},)")
    if weights.shape[0] != batch or weights.shape[2] != time:
        raise ValueError(f"weights {tuple(weights.shape)} do not match x {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if any(t.device != x.device for t in (hidden, w2r, b2r, weights)):
        raise ValueError("all inputs must be on the same device")
    if x.device.type == "cpu":
        return attentive_stats_reference(x, hidden, w2r, b2r, weights)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if wants_grad(x, hidden, w2r, b2r, weights):
        return AttnStatsFunction.apply(x, hidden, w2r, b2r, weights, operands)
    if operands is None:
        operands = prepare_attn_operands(w2, b2)
    return _launch(x, hidden, operands, weights)


fused_attentive_stats.launches = 0
