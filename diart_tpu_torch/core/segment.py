"""Time segments and sliding frame grids.

A copy of the two structures of ``diart_tpu/core/segment.py`` that the
aggregation geometry uses, with the same crop arithmetic (which decides
which frames the overlap-add reads). The port keeps its own copy because
importing anything under ``diart_tpu`` imports jax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["Segment", "SlidingWindow"]


def _r(x: float) -> float:
    """Round to 10 decimals before flooring/ceiling frame indices, so crop
    indices do not depend on accumulated timestamp noise."""
    return round(x, 10)


@dataclass(frozen=True, order=True)
class Segment:
    """A time interval ``[start, end)`` in seconds."""

    start: float = 0.0
    end: float = 0.0

    @property
    def duration(self) -> float:
        return self.end - self.start if self.end > self.start else 0.0


class SlidingWindow:
    """Regular frame grid: frame ``i`` covers ``[start+i*step, +duration]``."""

    def __init__(self, duration: float = 0.030, step: float = 0.010, start: float = 0.0):
        if duration <= 0:
            raise ValueError("duration must be positive")
        if step <= 0:
            raise ValueError("step must be positive")
        self.duration = float(duration)
        self.step = float(step)
        self.start = float(start)

    def samples(self, from_duration: float, mode: str = "strict") -> int:
        """Number of frames in a span of ``from_duration`` seconds."""
        if mode == "strict":
            return int(math.floor(_r((from_duration - self.duration) / self.step))) + 1
        if mode == "loose":
            return int(math.floor(_r((from_duration + self.duration) / self.step)))
        if mode == "center":
            return int(np.rint(_r(from_duration / self.step)))
        raise ValueError(f"unknown mode {mode!r}")

    def closest_frame(self, t: float) -> int:
        return int(np.rint((t - self.start - 0.5 * self.duration) / self.step))

    def crop_range(
        self, focus: Segment, mode: str = "loose", fixed: Optional[float] = None
    ) -> Tuple[int, int]:
        """Frame index range ``[i, j)`` selected by cropping ``focus``."""
        if mode == "loose":
            i = int(math.ceil(_r((focus.start - self.duration - self.start) / self.step)))
            if fixed is None:
                j = int(math.floor(_r((focus.end - self.start) / self.step)))
                return i, j + 1
            return i, i + self.samples(fixed, mode="loose")
        if mode == "strict":
            i = int(math.ceil(_r((focus.start - self.start) / self.step)))
            if fixed is None:
                j = int(math.floor(_r((focus.end - self.duration - self.start) / self.step)))
                return i, j + 1
            return i, i + self.samples(fixed, mode="strict")
        if mode == "center":
            i = self.closest_frame(focus.start)
            if fixed is None:
                return i, self.closest_frame(focus.end) + 1
            return i, i + self.samples(fixed, mode="center")
        raise ValueError(f"unknown mode {mode!r}")
