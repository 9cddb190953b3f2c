"""ECAPA-TDNN speaker embedding (port of ``diart_tpu/models/ecapa.py``).

speechbrain's ``ECAPA_TDNN`` graph: log-mel frontend with per-utterance mean
normalization, a TDNN stem, three SE-Res2Blocks (dilation 2, 3, 4),
multi-layer feature aggregation, channel-attentive statistics pooling whose
attention the per-speaker frame weights re-normalize, a batch norm and a
linear projection. Activations are (batch, time, channels), as in the JAX
package, and submodules and parameters carry the flax names, so
:func:`diart_tpu_torch.weights.load_flax_params` maps a tree by path.

Trunk/head split as in the x-vector model: the trunk runs once per chunk,
the head pools it per speaker. Each SE-Res2Block runs as one call of
:func:`diart_tpu_torch.ops.se_res2.fused_se_res2_block` and the head's
attention statistics as one call of
:func:`diart_tpu_torch.ops.attn_stats.fused_attentive_stats` — on a CUDA
tensor the hand-written kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.se_res2 import fused_se_res2_block, kernel_operands
from .common import InferenceBatchNorm, QuantizableConv, attentive_stats_pool, held_operands, reflect_pad_time
from .fbank import speechbrain_log_mel

__all__ = ["EcapaTDNN"]


class _TDNNBlock(nn.Module):
    """speechbrain TDNNBlock on (B, T, C): reflect-padded 'same' Conv1d with
    bias in the compute dtype, ReLU, inference batch norm in that dtype."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1, dilation: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.kernel = kernel
        self.dilation = dilation
        self.conv = QuantizableConv(in_channels, features, kernel, dilation, compute_dtype)
        self.bn = InferenceBatchNorm(features, channel_dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel == 1 and not self.conv.int8(x):
            # a pointwise conv is a product on the channels axis
            dt = self.conv.compute_dtype
            y = F.linear(x.to(dt), self.conv.weight[:, :, 0].to(dt))
            y = y + self.conv.bias.to(y.dtype)
        else:
            x = reflect_pad_time(x, (self.kernel - 1) * self.dilation // 2)
            y = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return self.bn(torch.relu(y))


class _Res2Block(nn.Module):
    """speechbrain Res2NetBlock: ``scale`` channel groups; group i >= 2 adds
    the previous group's output to its input; each group is a TDNNBlock."""

    def __init__(self, features: int, kernel: int, dilation: int, scale: int = 8,
                 compute_dtype=torch.float32):
        super().__init__()
        self.scale = scale
        width = features // scale
        for i in range(scale - 1):
            setattr(self, f"block{i}", _TDNNBlock(width, width, kernel, dilation, compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=-1)
        outputs, y = [chunks[0]], None
        for i in range(1, self.scale):
            y = getattr(self, f"block{i - 1}")(chunks[i] if y is None else chunks[i] + y)
            outputs.append(y)
        return torch.cat(outputs, dim=-1)


class _SEBlock(nn.Module):
    """Squeeze-and-excitation over channels: time mean and gate MLP in f32,
    the excitation multiply in the activation dtype."""

    def __init__(self, features: int, bottleneck: int = 128):
        super().__init__()
        self.conv1 = nn.Linear(features, bottleneck)
        self.conv2 = nn.Linear(bottleneck, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=1, keepdim=True)
        s = torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))
        return x * s.to(x.dtype)


class _SERes2Block(nn.Module):
    def __init__(self, features: int, kernel: int, dilation: int, res2_scale: int = 8,
                 se_bottleneck: int = 128, compute_dtype=torch.float32):
        super().__init__()
        self.features = features
        self.dilation = dilation
        self.res2_scale = res2_scale
        self.tdnn1 = _TDNNBlock(features, features, 1, 1, compute_dtype)
        self.res2net = _Res2Block(features, kernel, dilation, res2_scale, compute_dtype)
        self.tdnn2 = _TDNNBlock(features, features, 1, 1, compute_dtype)
        self.se = _SEBlock(features, se_bottleneck)

    def folded_params(self) -> Tuple[torch.Tensor, ...]:
        """The kernel's 16-tuple: 1x1 weights as (in, out), group
        convolutions as (G, tap, in, out), batch norms folded to affines."""
        a1, c1 = self.tdnn1.bn.folded()
        a2, c2 = self.tdnn2.bn.folded()
        groups = [getattr(self.res2net, f"block{i}") for i in range(self.res2_scale - 1)]
        folded = [blk.bn.folded() for blk in groups]
        return (
            self.tdnn1.conv.weight[:, :, 0].t(), self.tdnn1.conv.bias, a1, c1,
            torch.stack([blk.conv.weight.permute(2, 1, 0) for blk in groups]),
            torch.stack([blk.conv.bias for blk in groups]),
            torch.stack([a for a, _ in folded]),
            torch.stack([c for _, c in folded]),
            self.tdnn2.conv.weight[:, :, 0].t(), self.tdnn2.conv.bias, a2, c2,
            self.se.conv1.weight.t(), self.se.conv1.bias,
            self.se.conv2.weight.t(), self.se.conv2.bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.features % self.res2_scale == 0:
            # the folded parameters laid out for the kernel once per dtype and held
            ops = held_operands(self, x.dtype, self.parameters(),
                                lambda: kernel_operands(self.folded_params(), x.dtype))
            return fused_se_res2_block(x, self.folded_params() if ops is None else None, self.dilation,
                                       operands=ops)
        residual = x
        x = self.se(self.tdnn2(self.res2net(self.tdnn1(x))))
        return x + residual


class EcapaTDNN(nn.Module):
    """ECAPA-TDNN with external-weight-aware attentive statistics pooling;
    the defaults are speechbrain's voxceleb recipe (512 channels, 192-d)."""

    fbank_ring_kind = "speechbrain"  # the engine's incremental frontend

    def __init__(
        self,
        embedding_dim: int = 192,
        channels: int = 512,
        num_mels: int = 80,
        sample_rate: int = 16000,
        attention_bottleneck: int = 128,
        res2_scale: int = 8,
        se_bottleneck: int = 128,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        c, dt = channels, compute_dtype
        self.embedding_dim = embedding_dim
        self.channels = channels
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.attention_bottleneck = attention_bottleneck
        self.res2_scale = res2_scale
        self.se_bottleneck = se_bottleneck
        self.compute_dtype = compute_dtype
        self.stem = _TDNNBlock(num_mels, c, 5, 1, dt)
        self.block1 = _SERes2Block(c, 3, 2, res2_scale, se_bottleneck, dt)
        self.block2 = _SERes2Block(c, 3, 3, res2_scale, se_bottleneck, dt)
        self.block3 = _SERes2Block(c, 3, 4, res2_scale, se_bottleneck, dt)
        self.mfa = _TDNNBlock(3 * c, 3 * c, 1, 1, dt)
        self.att_local = nn.Linear(3 * c, attention_bottleneck)
        self.att_global = nn.Linear(6 * c, attention_bottleneck, bias=False)
        self.att_bn = InferenceBatchNorm(attention_bottleneck, channel_dim=-1)
        self.att2 = nn.Linear(attention_bottleneck, 3 * c)
        self.asp_bn = InferenceBatchNorm(6 * c, channel_dim=-1)
        self.embedding = nn.Linear(6 * c, embedding_dim)

    def forward(self, waveform, weights=None):
        return self.head(self.trunk(waveform), weights)

    def features(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, num_mels) mean-normalized fbanks."""
        feats = speechbrain_log_mel(waveform[:, 0], num_mels=self.num_mels, sample_rate=self.sample_rate)
        return feats - feats.mean(dim=1, keepdim=True)

    def finalize_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        """The window-dependent tail of :meth:`features` on the ring's raw
        frames: the top_db floor and the per-utterance mean norm."""
        floor = raw.amax(dim=(1, 2), keepdim=True) - 80.0
        x = torch.maximum(raw, floor)
        return x - x.mean(dim=1, keepdim=True)

    def trunk_from_raw_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        return self.trunk_from_features(self.finalize_fbank(raw))

    def trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, 3 * channels)."""
        return self.trunk_from_features(self.features(waveform))

    def trunk_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, frames, num_mels) -> (B, frames, 3 * channels) in the compute
        dtype (the fbank frontend and the head's statistics stay f32)."""
        x = self.stem(feats.to(self.compute_dtype))
        b1 = self.block1(x)
        b2 = self.block2(b1)
        b3 = self.block3(b2)
        return self.mfa(torch.cat([b1, b2, b3], dim=-1))

    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames (B, T, C); weights (B, S, Tw) or None -> (B, S, dim) (or
        (B, dim))."""
        pooled, squeeze = attentive_stats_pool(
            frames, weights, self.att_local, self.att_global, self.att_bn, self.att2
        )
        emb = self.embedding(self.asp_bn(pooled))
        return emb[:, 0] if squeeze else emb
