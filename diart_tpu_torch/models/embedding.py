"""XVectorSincNet speaker embedding with weighted statistics pooling (port of
``diart_tpu/models/embedding.py``).

Trunk/head split as in the JAX package: :meth:`XVectorSincNet.trunk` runs
once per chunk, :meth:`XVectorSincNet.head` pools it per speaker. With the
fused head (the final TDNN is 1x1, as in the standard geometry) the trunk
stops before that TDNN and the head computes its projection, leaky ReLU,
batch norm and weighted moments in
:func:`diart_tpu_torch.ops.linear_stats.fused_linear_stats` — on a CUDA
tensor the hand-written kernel, so the (B, T, 1500) projection never
reaches memory. Its operands (the weight in the frames' dtype, the folded
batch norm) are laid out once and again only when a parameter changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear_stats import fused_linear_stats, prepare_stats_operands
from .common import InferenceBatchNorm, QuantizableConv, held_operands, resample_weights
from .sincnet import SincNet

__all__ = ["FusedStatsHead", "XVectorSincNet", "stats_from_moments", "weighted_stats_pool"]


def stats_from_moments(s1, s2, v1, v2, eps: float = 1e-8) -> torch.Tensor:
    """Pooled ``[mean, std]`` (reliability-weighted unbiased variance) from
    raw weighted moments: s1/s2 (B, S, C) sums of ``w*x`` / ``w*x**2``,
    v1/v2 (B, S) sums of ``w`` / ``w**2``."""
    mean = s1 / (v1 + eps)[..., None]
    sq_dev = s2 - 2 * mean * s1 + mean**2 * v1[..., None]
    denom = (v1 - v2 / torch.clamp(v1, min=eps) + eps)[..., None]
    var = torch.clamp(sq_dev / denom, min=0.0)
    positive = var > 0
    std = torch.where(positive, torch.sqrt(torch.where(positive, var, 1.0)), 0.0)
    return torch.cat([mean, std], dim=-1)


def weighted_stats_pool(frames: torch.Tensor, weights: torch.Tensor, eps: float = 1e-8):
    """Weighted mean + std pooling in pyannote ``StatsPool`` semantics.
    frames (B, T, C), weights (B, S, T) -> (B, S, 2C)."""
    w = weights.float()
    f = frames.float()
    s1 = torch.einsum("btc,bst->bsc", f, w)
    s2 = torch.einsum("btc,bst->bsc", f * f, w)
    return stats_from_moments(s1, s2, w.sum(-1), (w * w).sum(-1), eps).to(frames.dtype)


class FusedStatsHead:
    """The pooling head of the x-vector families (this module's and
    :class:`diart_tpu_torch.models.xvect.XVectorFbank`): with the fused head
    (the final TDNN is 1x1, as in the standard geometry) the trunk stops
    before that TDNN and :meth:`pooled_stats` computes its projection,
    leaky ReLU, batch norm and weighted moments in
    :func:`fused_linear_stats`, with the operands laid out once and held
    (:func:`held_operands`). The class sets ``tdnn_specs``, ``tdnn{i}`` and
    ``tdnn{i}_norm``."""

    @property
    def fused_head(self) -> bool:
        """Whether the final TDNN is a pointwise projection the fused head
        can take over (true for the standard geometry)."""
        kernel, dilation, _ = self.tdnn_specs[-1]
        return kernel == 1 and dilation == 1

    def pooled_stats(self, frames: torch.Tensor, weights: Optional[torch.Tensor], fused: bool):
        """frames (B, T, C) from the trunk (the same ``fused``), weights
        (B, S, Tw) or None -> (weighted [mean, std] (B, S, 2C), squeeze)."""
        squeeze = weights is None
        if weights is None:
            weights = torch.ones(frames.shape[0], 1, frames.shape[1], device=frames.device)
        weights = resample_weights(weights, frames.shape[1])
        if not fused:
            return weighted_stats_pool(frames, weights), squeeze
        # the last TDNN's conv and batch norm, which the fused head computes
        last = len(self.tdnn_specs) - 1
        conv, norm = getattr(self, f"tdnn{last}"), getattr(self, f"tdnn{last}_norm")
        raw = lambda: (conv.weight[:, :, 0].t(), conv.bias, *norm.folded())
        ops = held_operands(self, ("linear_stats", frames.dtype), [*conv.parameters(), *norm.parameters()],
                            lambda: prepare_stats_operands(*raw(), frames.dtype))
        wf = weights.float()
        s1, s2 = fused_linear_stats(frames, *(raw() if ops is None else (None,) * 4), wf, operands=ops)
        return stats_from_moments(s1, s2, wf.sum(-1), (wf * wf).sum(-1)), squeeze


class XVectorSincNet(FusedStatsHead, nn.Module):
    """SincNet + TDNN x-vector; TDNN (kernel, dilation, channels) =
    (5,1,512), (3,2,512), (3,3,512), (1,1,512), (1,1,1500)."""

    def __init__(
        self,
        embedding_dim: int = 512,
        sample_rate: int = 16000,
        compute_dtype=torch.float32,
        tdnn_specs: Tuple[Tuple[int, int, int], ...] = (
            (5, 1, 512), (3, 2, 512), (3, 3, 512), (1, 1, 512), (1, 1, 1500),
        ),
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.tdnn_specs = tuple(tdnn_specs)
        self.sincnet = SincNet(sample_rate=sample_rate, compute_dtype=compute_dtype)
        in_dim = 60
        for i, (kernel, dilation, channels) in enumerate(self.tdnn_specs):
            setattr(self, f"tdnn{i}", QuantizableConv(in_dim, channels, kernel, dilation, compute_dtype))
            setattr(self, f"tdnn{i}_norm", InferenceBatchNorm(channels))
            in_dim = channels
        self.embedding = nn.Linear(2 * in_dim, embedding_dim)

    def forward(self, waveform, weights=None):
        return self.head(self.trunk(waveform), weights)

    def trunk(
        self, waveform: torch.Tensor, fused_head: Optional[bool] = None,
        sinc_pooled: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """waveform (B, 1, samples) -> frames (B, T, C). With the fused head
        the last TDNN is left to :meth:`head` and the frames stay in the
        compute dtype; otherwise they are the full stack's output in f32.
        ``sinc_pooled``: see ``SincNet``."""
        fused = self.fused_head if fused_head is None else fused_head
        x = self.sincnet(waveform, sinc_pooled).to(self.compute_dtype)  # (B, 60, T)
        layers = len(self.tdnn_specs) - (1 if fused else 0)
        for i in range(layers):
            if x.shape[-1] < 1:
                break
            x = F.leaky_relu(getattr(self, f"tdnn{i}")(x), 0.01)
            x = getattr(self, f"tdnn{i}_norm")(x.float()).to(self.compute_dtype)
        if x.shape[-1] < 1:
            raise ValueError(
                f"waveform too short for the x-vector receptive field: "
                f"{waveform.shape[-1]} samples leave no frames after the TDNN stack"
            )
        x = x.transpose(1, 2).contiguous()
        return x if fused else x.float()

    def head(
        self,
        frames: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        fused_head: Optional[bool] = None,
    ) -> torch.Tensor:
        """frames (B, T, C) from :meth:`trunk` (same ``fused_head``), weights
        (B, S, Tw) or None -> (B, S, embedding_dim) (or (B, dim))."""
        fused = self.fused_head if fused_head is None else fused_head
        stats, squeeze = self.pooled_stats(frames, weights, fused)
        emb = self.embedding(stats.float())
        return emb[:, 0] if squeeze else emb
