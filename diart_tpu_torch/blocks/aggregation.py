"""Latency-controlled aggregation of overlapping windows (a numpy copy of
``diart_tpu/blocks/aggregation.py``).

Behavioral equivalent of diart's ``DelayedAggregation`` and its strategies
(diart's ``blocks/aggregation.py``). The streaming engine uses the
static-gather formulation of :mod:`diart_tpu_torch.ops.aggregation`; the
pipelines aggregate on the host with this block.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.segment import Segment, SlidingWindow, SlidingWindowFeature

__all__ = ["AggregationStrategy", "DelayedAggregation"]


class AggregationStrategy:
    """How to combine the cropped focus regions of overlapping buffers."""

    def __init__(self, cropping_mode: str = "loose"):
        assert cropping_mode in ("strict", "loose", "center"), cropping_mode
        self.cropping_mode = cropping_mode

    @staticmethod
    def build(name: str, cropping_mode: str = "loose") -> "AggregationStrategy":
        assert name in ("mean", "hamming", "first"), name
        if name == "mean":
            return AverageStrategy(cropping_mode)
        if name == "hamming":
            return HammingWeightedAverageStrategy(cropping_mode)
        return FirstOnlyStrategy(cropping_mode)

    def aggregate(
        self, buffers: List[SlidingWindowFeature], focus: Segment
    ) -> np.ndarray:
        raise NotImplementedError

    def __call__(
        self, buffers: List[SlidingWindowFeature], focus: Segment
    ) -> SlidingWindowFeature:
        data = self.aggregate(buffers, focus)
        resolution = focus.duration / data.shape[0]
        window = SlidingWindow(start=focus.start, duration=resolution, step=resolution)
        return SlidingWindowFeature(data, window)


class HammingWeightedAverageStrategy(AggregationStrategy):
    """Average weighted by each buffer's aligned Hamming window
    (aggregation.py:73-92): center frames of a chunk count more than edges."""

    def aggregate(self, buffers, focus):
        num_frames = buffers[0].data.shape[0]
        hamming = np.hamming(num_frames)[:, None]
        weights, values = [], []
        for buffer in buffers:
            values.append(
                buffer.crop(focus, mode=self.cropping_mode, fixed=focus.duration)
            )
            h = SlidingWindowFeature(hamming, buffer.sliding_window)
            weights.append(h.crop(focus, mode=self.cropping_mode, fixed=focus.duration))
        weights, values = np.stack(weights), np.stack(values)
        return np.sum(weights * values, axis=0) / np.sum(weights, axis=0)


class AverageStrategy(AggregationStrategy):
    def aggregate(self, buffers, focus):
        stacked = np.stack(
            [
                buffer.crop(focus, mode=self.cropping_mode, fixed=focus.duration)
                for buffer in buffers
            ]
        )
        return np.mean(stacked, axis=0)


class FirstOnlyStrategy(AggregationStrategy):
    def aggregate(self, buffers, focus):
        return buffers[0].crop(focus, mode=self.cropping_mode, fixed=focus.duration)


class DelayedAggregation:
    """Aggregate the ``[end - latency, end - latency + step]`` region across
    the rolling buffer of the last ``round(latency/step)`` windows
    (aggregation.py:120-218)."""

    def __init__(
        self,
        step: float,
        latency: Optional[float] = None,
        strategy: str = "hamming",
        cropping_mode: str = "loose",
    ):
        self.step = step
        self.latency = step if latency is None else latency
        assert self.step <= self.latency, "latency must be at least one step"
        self.strategy_name = strategy
        self.cropping_mode = cropping_mode
        self.num_overlapping_windows = int(round(self.latency / self.step))
        self.aggregate = AggregationStrategy.build(strategy, cropping_mode)

    def _prepend_first_output(
        self,
        output_window: SlidingWindowFeature,
        output_region: Segment,
        buffers: List[SlidingWindowFeature],
    ) -> SlidingWindowFeature:
        """Extend the very first output back to t=0 with the first buffer's
        scores (aggregation.py:188-212) so the initial latency gap is
        covered."""
        if len(buffers) == 1 and buffers[-1].extent.start == 0:
            num_frames = output_window.data.shape[0]
            first_region = Segment(0, output_region.end)
            first_output = buffers[0].crop(
                first_region, mode=self.cropping_mode, fixed=first_region.duration
            ).copy()
            first_output[-num_frames:] = output_window.data
            resolution = output_region.end / first_output.shape[0]
            return SlidingWindowFeature(
                first_output,
                SlidingWindow(start=0, duration=resolution, step=resolution),
            )
        return output_window

    def __call__(self, buffers: List[SlidingWindowFeature]) -> SlidingWindowFeature:
        start = buffers[-1].extent.end - self.latency
        region = Segment(start, start + self.step)
        return self._prepend_first_output(
            self.aggregate(buffers, region), region, buffers
        )
