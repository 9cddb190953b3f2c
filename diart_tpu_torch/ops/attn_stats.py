"""Fused channel-attention weighted statistics.

Counterpart of ``diart_tpu/ops/pallas_attn_stats.py``'s
``fused_attentive_stats``, equal to its ``attentive_stats_reference``. On
a CUDA tensor it launches the hand-written kernel ``csrc/attn_stats.cu``,
which never writes the (B, T, C) attention logits or products to memory;
on a CPU tensor it runs the plain version below. There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["attentive_stats_reference", "fused_attentive_stats"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPEAKERS = 8  # the kernel's register accumulators are instantiated for S <= 8


def attentive_stats_reference(x, hidden, w2, b2, weights):
    """Plain version: ``(den, s1, s2)``, each (B, S, C) f32, with
    ``alpha = softmax_t(hidden @ w2 + b2)`` per channel and
    ``den = sum_t w alpha``, ``s1 = sum_t w alpha x``,
    ``s2 = sum_t w alpha x^2``; everything in f32.

    x: (B, T, C) f32 or bf16; hidden: (B, T, H); w2: (H, C); b2: (C,);
    weights: (B, S, T) non-negative."""
    logits = torch.matmul(hidden.float(), w2.float()) + b2.float()
    alpha = torch.softmax(logits, dim=1)
    xf = x.float()
    wt = weights.float()
    ax = alpha * xf
    den = torch.einsum("btc,bst->bsc", alpha, wt)
    s1 = torch.einsum("btc,bst->bsc", ax, wt)
    s2 = torch.einsum("btc,bst->bsc", ax * xf, wt)
    return den, s1, s2


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attn_stats_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.attn_stats_launch.restype = i


def fused_attentive_stats(x, hidden, w2, b2, weights):
    """``(den, s1, s2)`` of channel-attentive weighted pooling without
    materializing the (B, T, C) logits or products.

    x: (B, T, C) f32 or bf16; hidden: (B, T, H) (cast to f32, as the TPU
    wrapper does); w2: (H, C); b2: (C,); weights: (B, S, T). Returns three
    (B, S, C) float32 tensors.
    """
    if x.dim() != 3 or hidden.dim() != 3 or w2.dim() != 2 or weights.dim() != 3:
        raise ValueError("x must be (B, T, C), hidden (B, T, H), w2 (H, C), weights (B, S, T)")
    batch, time, channels = x.shape
    bottleneck = hidden.shape[2]
    if hidden.shape[:2] != (batch, time):
        raise ValueError(f"hidden {tuple(hidden.shape)} does not match x {tuple(x.shape)}")
    if tuple(w2.shape) != (bottleneck, channels) or tuple(b2.shape) != (channels,):
        raise ValueError(f"w2 must be ({bottleneck}, {channels}) and b2 ({channels},)")
    if weights.shape[0] != batch or weights.shape[2] != time:
        raise ValueError(f"weights {tuple(weights.shape)} do not match x {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if any(t.device != x.device for t in (hidden, w2, b2, weights)):
        raise ValueError("all inputs must be on the same device")
    if x.device.type == "cpu":
        return attentive_stats_reference(x, hidden, w2, b2, weights)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    speakers = weights.shape[1]
    if not 1 <= speakers <= MAX_SPEAKERS:
        raise ValueError(f"the attention-stats kernel takes 1..{MAX_SPEAKERS} speakers; got {speakers}")
    lib = _build.library("attn_stats", _signature)
    f32 = lambda v: v.float().contiguous()
    xc, hc, wc, bc, wt = x.contiguous(), f32(hidden), f32(w2), f32(b2), f32(weights)
    den = torch.empty(batch, speakers, channels, device=x.device)
    s1, s2 = torch.empty_like(den), torch.empty_like(den)
    with torch.cuda.device(x.device):
        err = lib.attn_stats_launch(
            xc.data_ptr(), hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), wt.data_ptr(),
            den.data_ptr(), s1.data_ptr(), s2.data_ptr(), batch, time, channels,
            bottleneck, speakers, _DTYPES[x.dtype], _build.stream_handle(x.device),
        )
    _build.check(lib, "attn_stats", err)
    fused_attentive_stats.launches += 1
    return den, s1, s2


fused_attentive_stats.launches = 0
