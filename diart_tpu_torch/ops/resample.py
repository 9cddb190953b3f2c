"""Polyphase sample-rate conversion as one strided convolution (port of
``diart_tpu/ops/resample.py``).

The same Hann-windowed sinc kernel as the JAX package, built in numpy
float64 with one row per output phase (``new_freq`` rows after gcd
reduction); ``F.conv1d`` with stride ``orig_freq`` produces all phases at
once. The convolution runs in true f32 (TF32 off for the call) on the card.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.fbank import _constant
from ._numerics import true_f32

__all__ = ["resample", "resample_kernel"]


@lru_cache(maxsize=None)
def resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> Tuple[np.ndarray, int, int, int]:
    """Hann-windowed sinc interpolation kernel.

    Returns (kernel (new, 1, K) float32, width, reduced orig, reduced new).
    """
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx[None, :]) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
    kernel *= base_freq / orig
    return kernel.astype(np.float32)[:, None, :], width, orig, new


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample the last axis of ``waveform`` (..., samples) from
    ``orig_freq`` to ``new_freq`` -> (..., ceil(samples * new / orig)), on
    the tensor's device."""
    if orig_freq == new_freq:
        return waveform
    kernel, width, orig, new = resample_kernel(orig_freq, new_freq)
    shape = waveform.shape
    length = shape[-1]
    x = F.pad(waveform.reshape(-1, 1, length).float(), (width, width + orig))
    weight = _constant(kernel, waveform.device)  # held per device
    with true_f32(waveform.device):
        y = F.conv1d(x, weight, stride=orig)  # (batch, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    target_length = int(math.ceil(new * length / orig))
    return y[:, :target_length].reshape(*shape[:-1], target_length)
