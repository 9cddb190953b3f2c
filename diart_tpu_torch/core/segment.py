"""Time segments, sliding windows and windowed features.

A copy of ``diart_tpu/core/segment.py``: the aggregation geometry's crop
arithmetic (which decides which frames the overlap-add reads) and the
structures binarization and the session build on. The port keeps its own
copy because importing anything under ``diart_tpu`` imports jax.

Crop semantics (mirroring pyannote.core.SlidingWindow.crop):

* ``loose``  — frames intersecting the focus;
* ``strict`` — frames fully contained in the focus;
* ``center`` — frames whose center lies in the focus.

Out-of-range frames are padded by repeating the first/last frame, as
``pyannote.core.SlidingWindowFeature.crop`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["Segment", "SlidingWindow", "SlidingWindowFeature"]


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

    @property
    def middle(self) -> float:
        return 0.5 * (self.start + self.end)

    def __bool__(self) -> bool:
        return bool(self.end - self.start > 0)

    def intersects(self, other: "Segment") -> bool:
        return self.start < other.end and other.start < self.end

    def overlaps(self, t: float) -> bool:
        return self.start <= t <= self.end

    def __and__(self, other: "Segment") -> "Segment":
        """Intersection (may be empty)."""
        return Segment(max(self.start, other.start), min(self.end, other.end))

    def __or__(self, other: "Segment") -> "Segment":
        """Hull of both segments."""
        if not self:
            return other
        if not other:
            return self
        return Segment(min(self.start, other.start), max(self.end, other.end))

    def __contains__(self, other: "Segment") -> bool:
        return self.start <= other.start and self.end >= other.end

    def gap(self, other: "Segment") -> float:
        """Gap duration between two disjoint segments (<=0 if overlapping)."""
        if self.start < other.start:
            return other.start - self.end
        return self.start - other.end

    def __str__(self) -> str:
        return f"[{self.start:.3f} --> {self.end:.3f}]"


class SlidingWindow:
    """Regular frame grid: frame ``i`` covers ``[start+i*step, +duration]``."""

    def __init__(
        self,
        duration: float = 0.030,
        step: float = 0.010,
        start: float = 0.0,
        end: Optional[float] = None,
    ):
        if duration <= 0:
            raise ValueError("duration must be positive")
        if step <= 0:
            raise ValueError("step must be positive")
        self.duration = float(duration)
        self.step = float(step)
        self.start = float(start)
        self.end = end if end is None else float(end)

    def __getitem__(self, i: int) -> Segment:
        t0 = self.start + i * self.step
        return Segment(t0, t0 + self.duration)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SlidingWindow)
            and self.duration == other.duration
            and self.step == other.step
            and self.start == other.start
        )

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
        """Frame index range ``[i, j)`` selected by cropping ``focus``.

        Indices may exceed the bounds of an associated feature buffer; it is
        the feature's job to pad (see :meth:`SlidingWindowFeature.crop`).
        """
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
            # the frame whose centre is closest to each bound (np.rint), as
            # pyannote.core's closest_frame
            i = self.closest_frame(focus.start)
            if fixed is None:
                return i, self.closest_frame(focus.end) + 1
            return i, i + self.samples(fixed, mode="center")
        raise ValueError(f"unknown mode {mode!r}")

    def __iter__(self) -> Iterator[Segment]:
        if self.end is None:
            raise ValueError("cannot iterate over an unbounded sliding window")
        i = 0
        while True:
            seg = self[i]
            if seg.start >= self.end:
                return
            yield seg
            i += 1


class SlidingWindowFeature:
    """A ``(frames, dims)`` array whose rows sit on a :class:`SlidingWindow`."""

    def __init__(self, data: np.ndarray, sliding_window: SlidingWindow):
        self.data = np.asarray(data)
        self.sliding_window = sliding_window

    @property
    def extent(self) -> Segment:
        """Span from the start of the first frame to the end of the last."""
        num_frames = self.data.shape[0]
        sw = self.sliding_window
        return Segment(sw.start, sw.start + (num_frames - 1) * sw.step + sw.duration)

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, item):
        return self.data[item]

    def crop_indices(
        self, focus: Segment, mode: str = "loose", fixed: Optional[float] = None
    ) -> np.ndarray:
        """Frame indices :meth:`crop` reads: out-of-range ones clipped to the
        first or last frame."""
        i, j = self.sliding_window.crop_range(focus, mode=mode, fixed=fixed)
        return np.clip(np.arange(i, j), 0, self.data.shape[0] - 1)

    def crop(
        self, focus: Segment, mode: str = "loose", fixed: Optional[float] = None
    ) -> np.ndarray:
        """Crop to a focus segment; out-of-range rows repeat the edge rows."""
        if self.data.shape[0] == 0:
            raise ValueError("cannot crop an empty feature")
        return self.data[self.crop_indices(focus, mode=mode, fixed=fixed)]
