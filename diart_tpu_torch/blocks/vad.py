"""Voice activity detection pipeline (port of ``diart_tpu/blocks/vad.py``;
diart's ``blocks/vad.py``): segmentation only, the per-frame max over
speakers, the same delayed aggregation and binarization, and a single
``"speech"`` label. Like :class:`SpeakerDiarization`, a call is a
:meth:`~VoiceActivityDetection.dispatch` (one copy in, the forward, no host
wait) and a :meth:`~VoiceActivityDetection.fetch` (one copy out, the host
loop)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import utils
from ..core.annotation import Annotation
from ..core.segment import SlidingWindowFeature
from ..metrics import BaseMetric, DetectionErrorRate
from ..models import SegmentationModel
from ..parallel.engine import to_device
from . import base
from .diarization import stack_chunks
from .utils import resolve_device

__all__ = ["VoiceActivityDetectionConfig", "VoiceActivityDetection"]


def _speech(activity: Annotation) -> Annotation:
    """The binarized activity's turns under the one label ``"speech"``."""
    return activity.get_timeline(copy=False).to_annotation(utils.repeat_label("speech"))


class VoiceActivityDetectionConfig(base.PipelineConfig):
    """device: where the pipeline runs; a segmentation model that is passed
    in sets it (a ``device`` that is not its raises), else the card, where
    ``tpu/pyannet`` is built. The forward's numerics follow the precision
    policy active at call time."""

    def __init__(
        self,
        segmentation: Optional[SegmentationModel] = None,
        duration: float = 5.0,
        step: float = 0.5,
        latency: Optional[Union[float, str]] = None,
        tau_active: float = 0.6,
        device=None,
        sample_rate: int = 16000,
        **kwargs,
    ):
        super().__init__(duration, step, latency, sample_rate)
        self.device = resolve_device([segmentation], device)
        self.segmentation = segmentation or SegmentationModel.from_pretrained(
            "tpu/pyannet", device=self.device
        )
        self.tau_active = tau_active


class VoiceActivityDetection(base.Pipeline):
    def __init__(self, config: Optional[VoiceActivityDetectionConfig] = None):
        self._config = VoiceActivityDetectionConfig() if config is None else config
        self.device = self._config.device
        self._init_aggregation()

    @staticmethod
    def get_config_class() -> type:
        return VoiceActivityDetectionConfig

    @staticmethod
    def suggest_metric() -> BaseMetric:
        return DetectionErrorRate(collar=0, skip_overlap=False)

    @staticmethod
    def hyper_parameters() -> Sequence[base.HyperParameter]:
        return [base.TauActive]

    @property
    def config(self) -> VoiceActivityDetectionConfig:
        return self._config

    def reset(self):
        self.set_timestamp_shift(0.0)
        self.chunk_buffer, self.pred_buffer = [], []

    def set_timestamp_shift(self, shift: float):
        self.timestamp_shift = shift

    @torch.no_grad()
    def dispatch(self, waveforms: Sequence[SlidingWindowFeature]) -> torch.Tensor:
        """Queue the forward of a call on consecutive chunks: voice activity
        (N, frames, 1) on the device; waits for nothing on the card."""
        cfg = self._config
        batch = to_device(stack_chunks(waveforms, cfg.duration, cfg.sample_rate), self.device)
        wave = batch.transpose(1, 2)
        if cfg.segmentation.host_only:  # an ONNX model runs on the host
            seg = torch.as_tensor(np.asarray(cfg.segmentation(wave.cpu().numpy())), device=batch.device)
        else:
            seg = cfg.segmentation(wave)
        return seg.amax(dim=-1, keepdim=True)

    def fetch(
        self, waveforms: Sequence[SlidingWindowFeature], voice: torch.Tensor
    ) -> List[Tuple[Annotation, SlidingWindowFeature]]:
        """Copy :meth:`dispatch`'s activity to the host (once) and build each
        chunk's (annotation, aggregated audio) pair."""
        return self._aggregate(waveforms, voice.cpu().numpy(), label=_speech)

    def __call__(
        self, waveforms: Sequence[SlidingWindowFeature]
    ) -> List[Tuple[Annotation, SlidingWindowFeature]]:
        return self.fetch(waveforms, self.dispatch(waveforms))
