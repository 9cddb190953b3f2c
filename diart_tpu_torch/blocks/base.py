"""Pipeline and configuration base classes and the tunable hyper-parameters
(port of ``diart_tpu/blocks/base.py``; diart's ``blocks/base.py``).

Pipelines are stateful stream processors consuming batches of consecutive
sliding-window chunks; configs expose the time geometry and the file-padding
computation the runtime uses (diart's ``base.py:81-85``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
from .. import utils
from ..audio import AudioLoader, FilePath
from ..core.annotation import Annotation
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..metrics import BaseMetric
from .aggregation import DelayedAggregation
from .utils import Binarize

__all__ = [
    "HyperParameter",
    "TauActive",
    "RhoUpdate",
    "DeltaNew",
    "PipelineConfig",
    "Pipeline",
]


@dataclass
class HyperParameter:
    """A tunable pipeline hyper-parameter (diart's ``base.py:12-47``)."""

    name: str
    low: float
    high: float

    @staticmethod
    def from_name(name: str) -> "HyperParameter":
        if name == "tau_active":
            return TauActive
        if name == "rho_update":
            return RhoUpdate
        if name == "delta_new":
            return DeltaNew
        raise ValueError(f"hyper-parameter '{name}' not recognized")


TauActive = HyperParameter("tau_active", low=0.0, high=1.0)
RhoUpdate = HyperParameter("rho_update", low=0.0, high=1.0)
DeltaNew = HyperParameter("delta_new", low=0.0, high=2.0)


class PipelineConfig:
    """Time geometry + resources needed to build and run a pipeline.

    ``latency``: ``None`` / ``"min"`` is one step, ``"max"`` the chunk
    duration, else seconds."""

    def __init__(self, duration: float, step: float, latency: Optional[Any], sample_rate: int):
        self._duration = duration
        self._step = step
        self._latency = resolve_latency(latency, step, duration)
        self._sample_rate = sample_rate

    @property
    def duration(self) -> float:
        """Input chunk duration in seconds."""
        return self._duration

    @property
    def step(self) -> float:
        """Shift between consecutive chunks in seconds."""
        return self._step

    @property
    def latency(self) -> float:
        """Algorithmic latency in seconds: at stream time t the pipeline
        emits predictions for time t - latency."""
        return self._latency

    @property
    def sample_rate(self) -> int:
        """Expected input sample rate."""
        return self._sample_rate

    def get_file_padding(self, filepath: FilePath) -> Tuple[float, float]:
        """(left, right) zero-padding so a file's predictions align to t=0
        and cover its full duration (diart's ``base.py:81-85``,
        ``utils.py:69-88``)."""
        file_duration = AudioLoader(self.sample_rate, mono=True).get_duration(filepath)
        right = utils.get_padding_right(self.latency, self.step)
        left = utils.get_padding_left(file_duration + right, self.duration)
        return left, right


def resolve_latency(latency: Optional[Any], step: float, duration: float) -> float:
    """``None`` / ``"min"`` -> one step, ``"max"`` -> the chunk duration."""
    if latency is None or latency == "min":
        return step
    if latency == "max":
        return duration
    return latency


class Pipeline(ABC):
    """A streaming audio pipeline (diart's ``base.py:88-137``)."""

    @staticmethod
    @abstractmethod
    def get_config_class() -> type: ...

    @staticmethod
    @abstractmethod
    def suggest_metric() -> BaseMetric: ...

    @staticmethod
    @abstractmethod
    def hyper_parameters() -> Sequence[HyperParameter]: ...

    @property
    @abstractmethod
    def config(self) -> PipelineConfig: ...

    @abstractmethod
    def reset(self): ...

    @abstractmethod
    def set_timestamp_shift(self, shift: float): ...

    @abstractmethod
    def __call__(
        self, waveforms: Sequence[SlidingWindowFeature]
    ) -> Sequence[Tuple[Any, SlidingWindowFeature]]:
        """Process consecutive chunks; return (prediction, audio) pairs."""

    # -- the host half shared by the pipelines (diart's aggregation policy) --
    def _init_aggregation(self):
        """Check the latency and set up the delayed aggregations of scores
        (Hamming, loose) and audio (first, center), binarize at
        ``config.tau_active``, and an empty stream."""
        cfg = self.config
        msg = f"latency should be in the range [{cfg.step}, {cfg.duration}]"
        assert cfg.step <= cfg.latency <= cfg.duration, msg
        self.pred_aggregation = DelayedAggregation(
            cfg.step, cfg.latency, strategy="hamming", cropping_mode="loose"
        )
        self.audio_aggregation = DelayedAggregation(
            cfg.step, cfg.latency, strategy="first", cropping_mode="center"
        )
        self.binarize = Binarize(cfg.tau_active)
        self.timestamp_shift = 0.0
        self.chunk_buffer, self.pred_buffer = [], []

    def _aggregate(
        self,
        waveforms: Sequence[SlidingWindowFeature],
        scores: np.ndarray,
        label: Callable[[Annotation], Annotation] = lambda annotation: annotation,
    ) -> List[Tuple[Annotation, SlidingWindowFeature]]:
        """Each chunk's host scores (frames, speakers) join the stream's
        buffers; the two delayed aggregations, binarize, ``label`` (the
        pipeline's labelling of the binarized annotation) and the timestamp
        shift make its (annotation, aggregated audio) pair. The buffers keep
        the chunks that still overlap the next one."""
        seg_resolution = waveforms[0].extent.duration / scores.shape[1]
        outputs = []
        for wav, chunk_scores in zip(waveforms, scores):
            sw = SlidingWindow(start=wav.extent.start, duration=seg_resolution, step=seg_resolution)
            self.chunk_buffer.append(wav)
            self.pred_buffer.append(SlidingWindowFeature(chunk_scores, sw))

            agg_waveform = self.audio_aggregation(self.chunk_buffer)
            prediction = label(self.binarize(self.pred_aggregation(self.pred_buffer)))
            if self.timestamp_shift != 0:
                prediction = prediction.shift(self.timestamp_shift)
            outputs.append((prediction, agg_waveform))

            if len(self.chunk_buffer) == self.pred_aggregation.num_overlapping_windows:
                self.chunk_buffer = self.chunk_buffer[1:]
                self.pred_buffer = self.pred_buffer[1:]
        return outputs
