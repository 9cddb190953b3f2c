"""WeSpeaker-style ResNet34 speaker embedding (port of
``diart_tpu/models/resnet.py``).

wespeaker's ``resnet34`` graph: the kaldi fbank frontend with per-utterance
mean normalization, a 2-D ResNet34 over the (time, mel) plane, temporal
statistics pooling of the flattened (channels, freq) maps and a linear
projection. Submodules and parameters carry the flax names.

The trunk runs in ``compute_dtype`` as NCHW with H = time and W = mel; its
convolutions are plain ``torch.nn.functional.conv2d`` (the JAX package runs
them outside any Pallas kernel as well). The head pools in f32 with the
external per-speaker frame weights (uniform weights give wespeaker's TSTP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .common import InferenceBatchNorm, QuantizableConv, resample_weights
from .fbank import kaldi_log_mel

__all__ = ["ResNet34"]


class _BasicBlock(nn.Module):
    """torchvision/wespeaker BasicBlock: 3x3 conv-bn-relu, 3x3 conv-bn, an
    optional 1x1 stride-s downsample of the residual, relu."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, bias=False)
        self.conv1 = QuantizableConv(in_channels, features, (3, 3), stride=stride, padding=1, **kw)
        self.bn1 = InferenceBatchNorm(features)
        self.conv2 = QuantizableConv(features, features, (3, 3), padding=1, **kw)
        self.bn2 = InferenceBatchNorm(features)
        self.downsample = stride != 1 or in_channels != features
        if self.downsample:
            self.downsample_conv = QuantizableConv(in_channels, features, (1, 1), stride=stride, **kw)
            self.downsample_bn = InferenceBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return torch.relu(y + residual)


class ResNet34(nn.Module):
    """ResNet34 speaker embedding with weighted temporal statistics pooling;
    the defaults are the wespeaker voxceleb recipe (base 32 channels, stage
    depths (3, 4, 6, 3), 80 mels, 256-d embeddings)."""

    fbank_ring_kind = "kaldi"  # the engine's incremental frontend

    def __init__(
        self,
        embedding_dim: int = 256,
        base_channels: int = 32,
        depths: Tuple[int, int, int, int] = (3, 4, 6, 3),
        num_mels: int = 80,
        sample_rate: int = 16000,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        c = base_channels
        self.embedding_dim = embedding_dim
        self.base_channels = base_channels
        self.depths = tuple(depths)
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.conv1 = QuantizableConv(1, c, (3, 3), compute_dtype=compute_dtype, bias=False, padding=1,
                                     quantizable=False)
        self.bn1 = InferenceBatchNorm(c)
        self.blocks = []
        in_ch = c
        for stage, depth in enumerate(self.depths):
            features = c * 2**stage
            for i in range(depth):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, name, _BasicBlock(in_ch, features, stride, compute_dtype))
                self.blocks.append(name)
                in_ch = features
        freq = num_mels
        for _ in range(len(self.depths) - 1):
            freq = (freq - 1) // 2 + 1
        self.embedding = nn.Linear(2 * in_ch * freq, embedding_dim)

    def forward(self, waveform, weights=None):
        return self.head(self.trunk(waveform), weights)

    def features(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, num_mels) kaldi fbanks with CMN."""
        feats = kaldi_log_mel(waveform[:, 0], num_mels=self.num_mels, sample_rate=self.sample_rate)
        return feats - feats.mean(dim=1, keepdim=True)

    def finalize_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        """The window-dependent tail of :meth:`features` on the ring's raw
        frames: wespeaker's CMN."""
        return raw - raw.mean(dim=1, keepdim=True)

    def trunk_from_raw_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        return self.trunk_from_features(self.finalize_fbank(raw))

    def trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames', channels * freq')."""
        return self.trunk_from_features(self.features(waveform))

    def trunk_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, frames, num_mels) -> (B, frames', channels * freq') in the
        compute dtype, flattened per frame as (channels, freq), wespeaker's
        pre-pooling layout."""
        x = feats.to(self.compute_dtype)[:, None]  # (B, 1, T, F)
        x = torch.relu(self.bn1(self.conv1(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        b, c, t, f = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, t, c * f)

    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames (B, T', D); weights (B, S, Tw) or None -> (B, S, dim) (or
        (B, dim)): reliability-weighted mean and unbiased std (+1e-7
        before the root, as wespeaker's TSTP)."""
        squeeze = weights is None
        if weights is None:
            weights = torch.ones(frames.shape[0], 1, frames.shape[1], device=frames.device)
        w = resample_weights(weights, frames.shape[1]).float()
        f = frames.float()
        v1, v2 = w.sum(-1), (w * w).sum(-1)
        s1 = torch.einsum("btd,bst->bsd", f, w)
        s2 = torch.einsum("btd,bst->bsd", f * f, w)
        mean = s1 / torch.clamp(v1, min=1e-8)[..., None]
        sq_dev = s2 - 2 * mean * s1 + mean**2 * v1[..., None]
        denom = (v1 - v2 / torch.clamp(v1, min=1e-8))[..., None]
        var = torch.clamp(sq_dev / torch.clamp(denom, min=1e-8), min=0.0)
        emb = self.embedding(torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1))
        return emb[:, 0] if squeeze else emb
