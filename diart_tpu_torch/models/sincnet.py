"""SincNet learnable band-pass frontend, in PyTorch.

Port of ``diart_tpu/models/sincnet.py``:

  wav instance-norm -> SincConv(80, k=251, stride=10) -> |.| -> maxpool(3)
  -> instance-norm -> leaky_relu
  -> Conv1d(60, k=5) -> maxpool(3) -> instance-norm -> leaky_relu
  -> Conv1d(60, k=5) -> maxpool(3) -> instance-norm -> leaky_relu

Layout is PyTorch's (batch, channels, time) throughout. The JAX package's
phase-major convolution is a TPU tiling trick; here the stride-10
convolution runs directly on the (batch, 1, samples) waveform.

The filters are synthesized in f32 from the learnable cutoffs, as the JAX
package does. Their sin/cos arguments reach ~400 rad, where one f32 ulp of
the argument is ~3e-5 rad, so filter taps agree with the JAX synthesis to
~1e-5 relative, not bit for bit (stated in tests/test_torch_models.py).

The first stage (sinc convolution, |.|, max-pool(3) and the bf16 storage
of ``bf16_frontend``) is one call of ``ops/sinc_frontend.py``: on a card
one hand-written kernel that writes only the pooled result, on the CPU
``frontend_pool`` of the convolution below. ``SincNet`` holds the
filterbank's operands for that kernel once per version of the cutoffs.

Every convolution computed in f32 (the sinc filterbank always, the k=5
ones at ``compute_dtype=float32``) runs in true f32 on the card, whatever
torch's TF32 switches say (``ops/_numerics.py``), as JAX's does off the
TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import precision
from ..ops import _numerics
from ..ops.sinc_frontend import prepare_sinc_operands, sinc_frontend
from .common import held_operands

__all__ = [
    "SincConv",
    "SincNet",
    "frontend_pool",
    "num_sincnet_frames",
    "sinc_filters",
]


def _mel_init(num_filters: int, sample_rate: int, min_low_hz: float, min_band_hz: float):
    """Mel-spaced initial (low, band) cutoffs, as in the original SincNet."""
    low_hz = 30.0
    high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)

    def to_mel(hz):
        return 2595 * np.log10(1 + hz / 700)

    def to_hz(mel):
        return 700 * (10 ** (mel / 2595) - 1)

    mel = np.linspace(to_mel(low_hz), to_mel(high_hz), num_filters + 1)
    hz = to_hz(mel)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def _clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp`` whose gradient is half at a bound, as ``jnp.clip``'s
    (the top filter's high cutoff starts at exactly ``sample_rate / 2``;
    ``torch.clamp`` passes the whole gradient there). The mean of the clamp
    and of a copy whose gradient stops at the bounds: the same values.
    Without autograd it is the clamp alone."""
    clamped = torch.clamp(v, lo, hi)
    if not (torch.is_grad_enabled() and v.requires_grad):
        return clamped
    inside = torch.where((v > lo) & (v < hi), v, clamped.detach())
    return 0.5 * (clamped + inside)


def sinc_filters(
    low_hz: torch.Tensor,
    band_hz: torch.Tensor,
    kernel_size: int = 251,
    sample_rate: int = 16000,
    min_low_hz: float = 50.0,
    min_band_hz: float = 50.0,
) -> torch.Tensor:
    """ParamSincFB filterbank from its cutoffs: (num_filters // 2,) x 2 ->
    (num_filters, kernel_size), cosine filters first, then sine filters."""
    dev = low_hz.device
    low = min_low_hz + low_hz.float().abs()
    high = _clip(low + min_band_hz + band_hz.float().abs(), min_low_hz, sample_rate / 2)
    band = (high - low)[:, None]

    half = kernel_size // 2
    n_lin = torch.linspace(0.0, kernel_size / 2 - 1, half, device=dev)
    window = (0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel_size))[None, :]
    n_ = (
        2 * math.pi * torch.arange(-((kernel_size - 1) / 2.0), 0.0, device=dev) / sample_rate
    )[None, :]

    f_low = low[:, None] * n_
    f_high = high[:, None] * n_
    denom = n_ / 2
    cos_left = ((torch.sin(f_high) - torch.sin(f_low)) / denom) * window
    cos_filters = torch.cat([cos_left, 2 * band, cos_left.flip(1)], dim=1)
    sin_left = ((torch.cos(f_low) - torch.cos(f_high)) / denom) * window
    sin_filters = torch.cat([sin_left, torch.zeros_like(band), -sin_left.flip(1)], dim=1)
    return torch.cat([cos_filters / (2 * band), sin_filters / (2 * band)], dim=0)


def frontend_pool(y: torch.Tensor) -> torch.Tensor:
    """abs + non-overlapping max-pool(3) over time of the sinc-conv output
    (B, C, frames); with ``bf16_frontend`` the pre-pool activation is stored
    in bf16 (CUDA only). Returns f32."""
    if precision.enabled("bf16_frontend", y.device):
        y = y.to(torch.bfloat16)
    return F.max_pool1d(y.abs(), 3).float()


def _instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps=1e-5):
    """InstanceNorm1d(affine) with the biased variance, as ``jnp.var``.
    x: (batch, channels, time)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[None, :, None] + bias[None, :, None]


class SincConv(nn.Module):
    """Conv1d whose kernels are parameterized band-pass sinc filters
    (asteroid-filterbanks' ParamSincFB conventions)."""

    kernel_size = 251
    min_low_hz = 50.0
    min_band_hz = 50.0

    def __init__(self, num_filters: int = 80, stride: int = 10, sample_rate: int = 16000):
        super().__init__()
        assert num_filters % 2 == 0, "num_filters must be even (cos+sin pairs)"
        self.stride = stride
        self.sample_rate = sample_rate
        low, band = _mel_init(
            num_filters // 2, sample_rate, self.min_low_hz, self.min_band_hz
        )
        self.low_hz = nn.Parameter(torch.from_numpy(low))
        self.band_hz = nn.Parameter(torch.from_numpy(band))

    def filters(self) -> torch.Tensor:
        return sinc_filters(
            self.low_hz,
            self.band_hz,
            self.kernel_size,
            self.sample_rate,
            self.min_low_hz,
            self.min_band_hz,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, 1, samples) -> (batch, num_filters, frames)"""
        if x.shape[1] != 1:
            raise ValueError(f"SincConv expects mono (B, 1, samples); got {tuple(x.shape)}")
        filters = self.filters()[:, None, :]
        with _numerics.true_f32(x.device):
            return F.conv1d(x.float(), filters, stride=self.stride)


class SincNet(nn.Module):
    """The SincNet trunk: (batch, 1, samples) -> (batch, 60, frames).

    compute_dtype: dtype of the two k=5 convolutions; the waveform norm,
    the filter synthesis and every instance-norm stay f32."""

    stride = 10

    def __init__(self, sample_rate: int = 16000, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.wav_norm_scale = nn.Parameter(torch.ones(1))
        self.wav_norm_bias = nn.Parameter(torch.zeros(1))
        self.sinc = SincConv(stride=self.stride, sample_rate=sample_rate)
        self.norm1_scale = nn.Parameter(torch.ones(80))
        self.norm1_bias = nn.Parameter(torch.zeros(80))
        self.conv2 = nn.Conv1d(80, 60, 5)
        self.norm2_scale = nn.Parameter(torch.ones(60))
        self.norm2_bias = nn.Parameter(torch.zeros(60))
        self.conv3 = nn.Conv1d(60, 60, 5)
        self.norm3_scale = nn.Parameter(torch.ones(60))
        self.norm3_bias = nn.Parameter(torch.zeros(60))

    def forward(self, waveform: torch.Tensor, pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """waveform (batch, 1, samples) -> (batch, 60, frames). ``pooled``
        (batch, 80, pooled frames): the max-pooled ``|sinc conv|`` with the
        waveform-norm affine folded in, from the engine's stacked frontend
        (``parallel/engine.py``); the waveform, its norm and the sinc
        convolution are then skipped."""
        if pooled is None:
            x = _instance_norm(waveform.float(), self.wav_norm_scale, self.wav_norm_bias)
            # the filterbank's operands, made once per version of the cutoffs
            # and held, or the raw filters in a call that trains them
            ops = held_operands(self, "sinc_frontend", (self.sinc.low_hz, self.sinc.band_hz),
                                lambda: prepare_sinc_operands(self.sinc.filters()))
            pooled = sinc_frontend(x, self.sinc.filters() if ops is None else None, self.sinc.stride,
                                   operands=ops)
        x = pooled
        x = F.leaky_relu(_instance_norm(x, self.norm1_scale, self.norm1_bias), 0.01)
        cd = self.compute_dtype
        for i in (2, 3):
            conv = getattr(self, f"conv{i}")
            with _numerics.conv_scope(x.device, cd):
                x = F.conv1d(x.to(cd), conv.weight.to(cd), conv.bias.to(cd)).float()
            x = F.max_pool1d(x, 3)
            x = _instance_norm(
                x, getattr(self, f"norm{i}_scale"), getattr(self, f"norm{i}_bias")
            )
            x = F.leaky_relu(x, 0.01)
        return x


def num_sincnet_frames(num_samples: int, kernel_size: int = 251, stride: int = 10) -> int:
    """Output frames of the SincNet trunk (5 s @ 16 kHz -> 293)."""
    t = (num_samples - kernel_size) // stride + 1
    t //= 3
    t = (t - 5 + 1) // 3
    t = (t - 5 + 1) // 3
    return t
