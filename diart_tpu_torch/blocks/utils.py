"""Binarize / Resample / AdjustVolume blocks (port of
``diart_tpu/blocks/utils.py``; diart's ``blocks/utils.py``).

``Resample`` and ``AdjustVolume`` compute on ``device`` (the card unless the
caller asks for ``"cpu"``) and give back the caller's container.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..core.annotation import Annotation
from ..core.segment import SlidingWindowFeature
from ..features import TemporalFeatureFormatter, TemporalFeatures
from ..ops._build import require_cuda
from ..ops.binarize import binarize as _binarize
from ..ops.resample import resample as _resample
from ..parallel.engine import to_device

__all__ = ["Binarize", "Resample", "AdjustVolume", "resolve_device"]


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def resolve_device(models: Sequence[Any], device=None) -> torch.device:
    """The device a block or pipeline runs on: that of its ``models`` (the
    ones not None; host-only models count only where no other model is
    given), which must agree, and ``device``, where given, must be theirs;
    without models, ``device`` (the card unless ``"cpu"`` is asked for)."""
    present = [m for m in models if m is not None]
    devices = [m.device for m in ([m for m in present if not getattr(m, "host_only", False)] or present)]
    for other in devices[1:]:
        if not _same_device(devices[0], other):
            raise ValueError(f"the models are on different devices: {devices[0]} and {other}")
    if not devices:
        return require_cuda("cuda" if device is None else device)
    if device is not None and not _same_device(torch.device(device), devices[0]):
        raise ValueError(f"device {device!r} was asked for, but the models are on {devices[0]}")
    return devices[0]


class Binarize:
    """Frame probabilities -> continuous speaker turns
    (diart's ``blocks/utils.py:11-59``)."""

    def __init__(self, threshold: float, uri: Optional[str] = None):
        self.threshold = threshold
        self.uri = uri

    def __call__(self, segmentation: SlidingWindowFeature) -> Annotation:
        return _binarize(segmentation, self.threshold, uri=self.uri)


class Resample:
    """Sample-rate conversion block (diart's ``blocks/utils.py:62-89``)."""

    def __init__(self, sample_rate: int, resample_rate: int, device="cuda"):
        self.sample_rate = sample_rate
        self.resample_rate = resample_rate
        self.device = resolve_device([], device)
        self.formatter = TemporalFeatureFormatter()

    def __call__(self, waveform: TemporalFeatures) -> TemporalFeatures:
        wav = to_device(self.formatter.cast(waveform), self.device)  # (B, samples, ch)
        out = _resample(wav.transpose(1, 2), self.sample_rate, self.resample_rate)
        return self.formatter.restore_type(out.transpose(1, 2))


class AdjustVolume:
    """Normalize chunk volume to a target dB with a clipping guard
    (diart's ``blocks/utils.py:92-137``)."""

    def __init__(self, volume_in_db: float, device="cuda"):
        self.target_db = volume_in_db
        self.device = resolve_device([], device)
        self.formatter = TemporalFeatureFormatter()

    @staticmethod
    def get_volumes(waveforms: torch.Tensor) -> torch.Tensor:
        """(batch, samples, channels) -> per-channel dB (batch, 1, channels)."""
        return 10 * torch.log10(torch.mean(torch.abs(waveforms) ** 2, dim=1, keepdim=True))

    def __call__(self, waveform: TemporalFeatures) -> TemporalFeatures:
        wav = to_device(self.formatter.cast(waveform), self.device)
        gains = 10 ** ((self.target_db - self.get_volumes(wav)) / 20)
        # digitally silent input: -inf dB -> an infinite gain -> inf * 0 =
        # NaN downstream; silence passes through unchanged instead
        gains = torch.where(torch.isfinite(gains), gains, torch.ones_like(gains))
        wav = gains * wav
        maxima = torch.clamp(torch.amax(torch.abs(wav), dim=1, keepdim=True), min=1.0)
        return self.formatter.restore_type(wav / maxima)
