"""WeSpeaker-style ResNet34 speaker embedding (port of
``diart_tpu/models/resnet.py``).

wespeaker's ``resnet34`` graph: the kaldi fbank frontend with per-utterance
mean normalization, a 2-D ResNet34 over the (time, mel) plane, temporal
statistics pooling of the flattened (channels, freq) maps and a linear
projection. Submodules and parameters carry the flax names.

The trunk runs in ``compute_dtype`` over the (time, mel) plane. On a card
in bf16 (``int8_trunk`` off, no parameter trained) its activations are
channels-last, (B, T, F, C) as the JAX package keeps them, and each of its
36 convolutions is one launch of :func:`~diart_tpu_torch.ops.resnet_conv.
resnet_conv` with its batch norm, the block's residual add and ReLU in the
kernel's epilogue (the JAX package leaves the trunk to XLA, which fuses
the same). Every other call (the CPU, f32, the int8 trunk, training) runs
the composition of ``QuantizableConv``, ``InferenceBatchNorm``, the add and
ReLU over NCHW tensors with H = time and W = mel. The head pools in f32
with the external per-speaker frame weights (uniform weights give
wespeaker's TSTP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops._grad import wants_grad
from ..ops.resnet_conv import prepare_conv_operands, resnet_conv
from .common import InferenceBatchNorm, QuantizableConv, held_operands, int8_trunk_enabled, resample_weights
from .fbank import kaldi_log_mel

__all__ = ["ResNet34"]


def _fused_conv(conv: QuantizableConv, bn: InferenceBatchNorm, x, residual=None, relu=True):
    """``conv`` -> ``bn`` (-> + residual) (-> ReLU) on channels-last ``x``
    in one launch of the kernel, its operands held by ``conv``."""
    params = (conv.weight, bn.scale, bn.bias, bn.mean, bn.var)
    ops = held_operands(conv, "resnet_conv", params, lambda: prepare_conv_operands(conv.weight, *bn.folded()))
    scale, shift = bn.folded() if ops is None else (None, None)
    return resnet_conv(x, conv.weight, scale, shift, conv.stride, conv.padding, residual, relu, conv.compute_dtype,
                       operands=ops)


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

    def forward_channels_last(self, x: torch.Tensor) -> torch.Tensor:
        """The block on channels-last (B, T, F, C) bf16 activations on a
        card: three launches of the kernel (two without a downsample), the
        downsample's output the residual that ``conv2``'s epilogue adds."""
        y = _fused_conv(self.conv1, self.bn1, x)
        residual = _fused_conv(self.downsample_conv, self.downsample_bn, x, relu=False) if self.downsample else x
        return _fused_conv(self.conv2, self.bn2, y, residual=residual)


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

    def channels_last(self, feats: torch.Tensor) -> bool:
        """Whether the trunk runs on ``feats`` as the kernel's channels-last
        launches: a card, bf16, widths that are multiples of 8, the int8
        trunk off and no parameter trained in this call."""
        return (feats.is_cuda and self.compute_dtype == torch.bfloat16 and self.base_channels % 8 == 0
                and not int8_trunk_enabled(feats.device) and not wants_grad(*self.parameters()))

    def trunk_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, frames, num_mels) -> (B, frames', channels * freq') in the
        compute dtype, flattened per frame as (channels, freq), wespeaker's
        pre-pooling layout."""
        if self.channels_last(feats):
            x = _fused_conv(self.conv1, self.bn1, feats.contiguous()[..., None])
            for name in self.blocks:
                x = getattr(self, name).forward_channels_last(x)
            b, t, f, c = x.shape
            return x.transpose(2, 3).reshape(b, t, c * f)
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
