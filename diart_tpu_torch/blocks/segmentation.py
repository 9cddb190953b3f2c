"""Speaker segmentation block (port of ``diart_tpu/blocks/segmentation.py``;
diart's ``blocks/segmentation.py``): runs the segmentation model over
batched waveforms on the model's device and restores the caller's container
type."""

from __future__ import annotations

from typing import Union

from ..features import TemporalFeatureFormatter, TemporalFeatures
from ..models import SegmentationModel
from ..parallel.engine import to_device
from .utils import resolve_device

__all__ = ["SpeakerSegmentation"]


class SpeakerSegmentation:
    def __init__(self, model: SegmentationModel, device=None):
        self.model = model
        self.device = resolve_device([model], device)
        self.formatter = TemporalFeatureFormatter()

    @staticmethod
    def from_pretrained(
        model, use_hf_token: Union[str, bool, None] = True, device="cuda"
    ) -> "SpeakerSegmentation":
        return SpeakerSegmentation(SegmentationModel.from_pretrained(model, use_hf_token, device=device))

    def __call__(self, waveform: TemporalFeatures) -> TemporalFeatures:
        """waveform (samples, channels) or (batch, samples, channels) ->
        activations (batch, frames, speakers)."""
        wave = to_device(self.formatter.cast(waveform), self.device)  # (B, samples, ch)
        return self.formatter.restore_type(self.model(wave.transpose(1, 2)))
