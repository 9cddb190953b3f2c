"""Building blocks shared by the embedding models (port of the parts of
``diart_tpu/models/common.py`` the x-vector path uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InferenceBatchNorm", "QuantizableConv", "resample_weights"]


def resample_weights(weights: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Nearest-neighbour resample of per-frame weights (..., src) to the
    trunk's frame grid (pyannote's StatsPool interpolates the same way)."""
    src = weights.shape[-1]
    if src == num_frames:
        return weights
    idx = torch.arange(num_frames, device=weights.device) * src // num_frames
    return weights.index_select(-1, idx)


class QuantizableConv(nn.Module):
    """Dilated, unpadded 1-D convolution over (batch, channels, time), run in
    ``compute_dtype``; the bias is added in that dtype after the convolution,
    as the JAX module does. (The JAX module's int8 path is not ported.)"""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        dilation: int = 1,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        self.dilation = dilation
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(features, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv1d(x.to(dt), self.weight.to(dt), dilation=self.dilation)
        return y + self.bias.to(y.dtype)[None, :, None]


class InferenceBatchNorm(nn.Module):
    """Inference-form batch norm over (batch, channels, time) with running
    statistics held as parameters; the affine is folded in f32 and applied in
    the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def folded(self):
        """(a, b) with ``norm(x) == x * a + b``, both f32 (C,)."""
        a = self.scale * torch.rsqrt(self.var + 1e-5)
        return a, self.bias - self.mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.folded()
        return x * a.to(x.dtype)[None, :, None] + b.to(x.dtype)[None, :, None]
