"""TitaNet speaker embedding (port of ``diart_tpu/models/titanet.py``).

NeMo's titanet-large graph: the NeMo log-mel frontend with per-feature
normalization, a ContextNet-style encoder of time-channel separable
convolution blocks with global-context squeeze-excitation (prologue k=3;
mega blocks k=7/11/15 with 3 repeats and a residual; epilogue k=1 to
3 * channels), and channel-attentive statistics pooling into a linear
embedding. Submodules and parameters carry the flax names, so
:func:`diart_tpu_torch.weights.load_flax_params` maps a tree by path.

The trunk runs in ``compute_dtype`` over (batch, channels, time) and hands
the head (batch, time, 3 * channels); the frontend and the head's
statistics stay f32. The head is the ECAPA head's
:func:`diart_tpu_torch.models.common.attentive_stats_pool`: on a CUDA
tensor the hand-written attention-statistics kernel, with the scores'
weights laid out for it once and held.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .common import InferenceBatchNorm, QuantizableConv, attentive_stats_pool
from .fbank import nemo_log_mel

__all__ = ["TitaNet"]


class _SeparableConvBnRelu(nn.Module):
    """One repeat: depthwise conv (k, 'same' zeros) -> pointwise 1x1 -> BN
    [-> relu], on (B, C, T)."""

    def __init__(self, in_channels: int, features: int, kernel: int, relu: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.relu = relu
        self.dw = QuantizableConv(in_channels, in_channels, kernel, compute_dtype=compute_dtype,
                                  bias=False, padding=(kernel - 1) // 2, groups=in_channels,
                                  quantizable=False)
        self.pw = QuantizableConv(in_channels, features, 1, compute_dtype=compute_dtype, bias=False)
        self.bn = InferenceBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.pw(self.dw(x)))
        return torch.relu(x) if self.relu else x


class _SqueezeExcite(nn.Module):
    """Global-context squeeze-excitation: time mean and gate MLP in f32,
    the excitation multiply in the activation dtype."""

    def __init__(self, features: int, reduction: int = 8):
        super().__init__()
        self.fc1 = nn.Linear(features, features // reduction)
        self.fc2 = nn.Linear(features // reduction, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=2)  # (B, C)
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
        return x * s.to(x.dtype)[:, :, None]


class _TitaBlock(nn.Module):
    """ContextNet mega block: ``repeat`` separable convs, SE, an optional
    1x1 conv + BN residual, relu."""

    def __init__(self, in_channels: int, features: int, kernel: int, repeat: int = 1,
                 residual: bool = True, se_reduction: int = 8, compute_dtype=torch.float32):
        super().__init__()
        self.repeat = repeat
        self.residual = residual
        for r in range(repeat):
            setattr(self, f"rep{r}", _SeparableConvBnRelu(
                in_channels if r == 0 else features, features, kernel, relu=r < repeat - 1,
                compute_dtype=compute_dtype))
        self.se = _SqueezeExcite(features, se_reduction)
        if residual:
            self.res_conv = QuantizableConv(in_channels, features, 1, compute_dtype=compute_dtype,
                                            bias=False)
            self.res_bn = InferenceBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for r in range(self.repeat):
            x = getattr(self, f"rep{r}")(x)
        x = self.se(x)
        if self.residual:
            x = x + self.res_bn(self.res_conv(inp))
        return torch.relu(x)


class TitaNet(nn.Module):
    """TitaNet with external-weight-aware attentive statistics pooling; the
    defaults are the titanet-large recipe (1024 channels, epilogue 3072,
    192-d embeddings)."""

    fbank_ring_kind = "nemo"  # the engine's incremental frontend

    def __init__(
        self,
        embedding_dim: int = 192,
        channels: int = 1024,
        mega_kernels: Tuple[int, ...] = (7, 11, 15),
        repeat: int = 3,
        num_mels: int = 80,
        sample_rate: int = 16000,
        attention_bottleneck: int = 128,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        c, dt = channels, compute_dtype
        self.embedding_dim = embedding_dim
        self.channels = channels
        self.mega_kernels = tuple(mega_kernels)
        self.repeat = repeat
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.attention_bottleneck = attention_bottleneck
        self.compute_dtype = compute_dtype
        self.prologue = _TitaBlock(num_mels, c, 3, repeat=1, residual=False, compute_dtype=dt)
        for i, k in enumerate(self.mega_kernels):
            setattr(self, f"mega{i}", _TitaBlock(c, c, k, repeat=repeat, residual=True, compute_dtype=dt))
        self.epilogue = _TitaBlock(c, 3 * c, 1, repeat=1, residual=False, compute_dtype=dt)
        self.att_local = nn.Linear(3 * c, attention_bottleneck)
        self.att_global = nn.Linear(6 * c, attention_bottleneck, bias=False)
        self.att_bn = InferenceBatchNorm(attention_bottleneck, channel_dim=-1)
        self.att2 = nn.Linear(attention_bottleneck, 3 * c)
        self.emb_bn = InferenceBatchNorm(6 * c, channel_dim=-1)
        self.embedding = nn.Linear(6 * c, embedding_dim)

    def forward(self, waveform, weights=None):
        return self.head(self.trunk(waveform), weights)

    @staticmethod
    def _per_feature_norm(feats: torch.Tensor) -> torch.Tensor:
        """NeMo's ``per_feature`` normalization over frames: mean and
        unbiased std + 1e-5."""
        mean = feats.mean(dim=1, keepdim=True)
        t = feats.shape[1]
        var = ((feats - mean) ** 2).sum(dim=1, keepdim=True) / max(t - 1, 1)
        return (feats - mean) / (torch.sqrt(var) + 1e-5)

    def features(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, num_mels) normalized NeMo log-mels."""
        feats = nemo_log_mel(waveform[:, 0], num_mels=self.num_mels, sample_rate=self.sample_rate)
        return self._per_feature_norm(feats)

    def finalize_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        """The window-dependent tail of :meth:`features` on the ring's raw
        frames: the per-feature normalization."""
        return self._per_feature_norm(raw)

    def trunk_from_raw_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        return self.trunk_from_features(self.finalize_fbank(raw))

    def trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, 3 * channels)."""
        return self.trunk_from_features(self.features(waveform))

    def trunk_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, frames, num_mels) -> (B, frames, 3 * channels) in the compute
        dtype."""
        x = self.prologue(feats.to(self.compute_dtype).transpose(1, 2))
        for i in range(len(self.mega_kernels)):
            x = getattr(self, f"mega{i}")(x)
        return self.epilogue(x).transpose(1, 2).contiguous()

    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames (B, T, 3C); weights (B, S, Tw) or None -> (B, S, dim) (or
        (B, dim))."""
        pooled, squeeze = attentive_stats_pool(
            frames, weights, self.att_local, self.att_global, self.att_bn, self.att2
        )
        emb = self.embedding(self.emb_bn(pooled))
        return emb[:, 0] if squeeze else emb
