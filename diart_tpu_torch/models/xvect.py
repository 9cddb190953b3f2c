"""speechbrain fbank x-vector speaker embedding (port of
``diart_tpu/models/xvect.py``).

speechbrain's ``Xvector`` graph (``spkrec-xvect-voxceleb``): Fbank(24) with
per-utterance mean normalization, five reflect-padded 'same'
Conv1d -> LeakyReLU -> BatchNorm blocks with kernels (5, 3, 3, 1, 1) and
dilations (1, 2, 3, 1, 1), statistics pooling (unbiased std + 1e-5) and a
linear projection. Submodules and parameters carry the flax names.

Trunk/head split and pooling head as in
:class:`diart_tpu_torch.models.embedding.XVectorSincNet`
(:class:`~diart_tpu_torch.models.embedding.FusedStatsHead`): with the
fused head the trunk stops before the final 1x1 TDNN and the head computes
it with the weighted moments in
:func:`diart_tpu_torch.ops.linear_stats.fused_linear_stats` — on a CUDA
tensor the hand-written kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import InferenceBatchNorm, QuantizableConv
from .embedding import FusedStatsHead
from .fbank import speechbrain_log_mel

__all__ = ["XVectorFbank"]


class XVectorFbank(FusedStatsHead, nn.Module):
    """speechbrain x-vector: fbank frontend + TDNN stack + stats pooling;
    the defaults are the ``spkrec-xvect-voxceleb`` release (24 mels,
    512-d embeddings, channels (512, 512, 512, 512, 1500))."""

    fbank_ring_kind = "speechbrain"  # the engine's incremental frontend

    def __init__(
        self,
        embedding_dim: int = 512,
        num_mels: int = 24,
        sample_rate: int = 16000,
        compute_dtype=torch.float32,
        tdnn_specs: Tuple[Tuple[int, int, int], ...] = (
            (5, 1, 512), (3, 2, 512), (3, 3, 512), (1, 1, 512), (1, 1, 1500),
        ),
        std_eps: float = 1e-5,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.tdnn_specs = tuple(tuple(spec) for spec in tdnn_specs)
        self.std_eps = std_eps
        in_dim = num_mels
        for i, (kernel, dilation, channels) in enumerate(self.tdnn_specs):
            setattr(self, f"tdnn{i}", QuantizableConv(in_dim, channels, kernel, dilation, compute_dtype))
            setattr(self, f"tdnn{i}_norm", InferenceBatchNorm(channels))
            in_dim = channels
        self.embedding = nn.Linear(2 * in_dim, embedding_dim)

    def forward(self, waveform, weights=None):
        return self.head(self.trunk(waveform), weights)

    def features(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, num_mels) mean-normalized fbanks."""
        feats = speechbrain_log_mel(waveform[:, 0], num_mels=self.num_mels, sample_rate=self.sample_rate)
        return feats - feats.mean(dim=1, keepdim=True)

    def finalize_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        """The window-dependent tail of :meth:`features` on the ring's raw
        frames: the top_db floor and the per-utterance mean norm."""
        x = torch.maximum(raw, raw.amax(dim=(1, 2), keepdim=True) - 80.0)
        return x - x.mean(dim=1, keepdim=True)

    def trunk_from_raw_fbank(self, raw: torch.Tensor, fused_head: Optional[bool] = None) -> torch.Tensor:
        return self.trunk_from_features(self.finalize_fbank(raw), fused_head)

    def trunk(self, waveform: torch.Tensor, fused_head: Optional[bool] = None) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, channels)."""
        return self.trunk_from_features(self.features(waveform), fused_head)

    def trunk_from_features(self, feats: torch.Tensor, fused_head: Optional[bool] = None) -> torch.Tensor:
        """(B, frames, num_mels) -> (B, frames, channels). With the fused head
        the last TDNN is left to :meth:`head` and the frames stay in the
        compute dtype; otherwise they are the full stack's output in f32."""
        fused = self.fused_head if fused_head is None else fused_head
        x = feats.to(self.compute_dtype).transpose(1, 2)  # (B, mels, T)
        layers = len(self.tdnn_specs) - (1 if fused else 0)
        for i in range(layers):
            kernel, dilation, _ = self.tdnn_specs[i]
            pad = (kernel - 1) * dilation // 2
            if pad:
                x = F.pad(x, (pad, pad), mode="reflect")
            x = F.leaky_relu(getattr(self, f"tdnn{i}")(x), 0.01)
            x = getattr(self, f"tdnn{i}_norm")(x.float()).to(self.compute_dtype)
        x = x.transpose(1, 2).contiguous()
        return x if fused else x.float()

    def head(
        self,
        frames: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        fused_head: Optional[bool] = None,
    ) -> torch.Tensor:
        """frames (B, T, C) from the trunk (same ``fused_head``), weights
        (B, S, Tw) or None -> (B, S, embedding_dim) (or (B, dim)). Weighted
        moments in pyannote ``StatsPool`` semantics plus speechbrain's
        +1e-5 on the std half."""
        fused = self.fused_head if fused_head is None else fused_head
        stats, squeeze = self.pooled_stats(frames, weights, fused)
        mean, std = stats.float().chunk(2, dim=-1)
        emb = self.embedding(torch.cat([mean, std + self.std_eps], dim=-1))
        return emb[:, 0] if squeeze else emb
