"""Stream operators: sliding-window re-chunking and output accumulation
(port of ``diart_tpu/runtime/operators.py``).

Covers the operator surface of diart's ``operators.py``
(re-chunker ``:44-100``, rolling list ``:103-110``, unbounded accumulation
``:147-212``, fixed plot buffer ``:215-304``) with a different mechanical
design: each operator is a small stateful class with an explicit
``push(value) -> output`` method, lifted into the reactive chain with
``ops.map``/``ops.flat_map``. The classes are directly unit-testable without
a stream, and the re-chunker drains *all* complete windows per incoming
block (a block larger than one hop can't build up latency).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..core.annotation import Annotation
from ..core.segment import Segment, SlidingWindow, SlidingWindowFeature
from .rx import Observable, ops

Operator = Callable[[Observable], Observable]

__all__ = [
    "SlidingChunker",
    "rearrange_audio_stream",
    "buffer_slide",
    "accumulate_output",
    "buffer_output",
]


class SlidingChunker:
    """Turns arbitrary (1, n) sample blocks into overlapping windows.

    Keeps one flat FIFO of pending samples plus the absolute index of its
    first sample; window ``k`` covers absolute samples
    ``[k*hop, k*hop + window)``, so start times never drift from float
    accumulation.
    """

    def __init__(self, window_samples: int, hop_samples: int, sample_rate: int):
        self.window_samples = window_samples
        self.hop_samples = hop_samples
        self.sample_rate = sample_rate
        self._fifo = np.zeros((0,), np.float32)
        self._fifo_start = 0  # absolute sample index of fifo[0]
        self._next_window = 0  # index of the next window to emit
        self._skip = 0  # future samples no window needs (hop > window gaps)

    def push(self, block: np.ndarray) -> List[SlidingWindowFeature]:
        if block.ndim != 2 or block.shape[0] != 1:
            raise ValueError(
                f"waveform must have shape (1, samples) but {block.shape} was found"
            )
        data = block[0].astype(np.float32)
        if self._skip:
            # hop > window: the gap between consecutive windows is
            # discarded as it arrives (advancing _fifo_start past samples
            # that had not arrived yet would silently misalign every
            # later window)
            k = min(self._skip, data.shape[0])
            data = data[k:]
            self._fifo_start += k
            self._skip -= k
        self._fifo = np.concatenate([self._fifo, data])
        out: List[SlidingWindowFeature] = []
        while True:
            start_abs = self._next_window * self.hop_samples
            end_abs = start_abs + self.window_samples
            if self._fifo_start + self._fifo.shape[0] < end_abs:
                break
            lo = start_abs - self._fifo_start
            window = self._fifo[lo : lo + self.window_samples]
            resolution = SlidingWindow(
                start=start_abs / self.sample_rate,
                duration=1.0 / self.sample_rate,
                step=1.0 / self.sample_rate,
            )
            out.append(SlidingWindowFeature(window[:, None].copy(), resolution))
            self._next_window += 1
        # drop samples that no future window needs (clamped to what has
        # actually arrived; the remainder is skipped on arrival above)
        keep_from = self._next_window * self.hop_samples
        drop = keep_from - self._fifo_start
        if drop > 0:
            avail = min(drop, self._fifo.shape[0])
            self._fifo = self._fifo[avail:]
            self._fifo_start += avail
            self._skip = drop - avail
        return out


def rearrange_audio_stream(
    duration: float = 5.0, step: float = 0.5, sample_rate: int = 16000
) -> Operator:
    """Re-chunk a block stream into (duration, step) sliding windows."""
    chunker = SlidingChunker(
        window_samples=int(round(sample_rate * duration)),
        hop_samples=int(round(sample_rate * step)),
        sample_rate=sample_rate,
    )

    def op(source: Observable) -> Observable:
        return source.pipe(ops.flat_map(chunker.push))

    return op


def buffer_slide(n: int) -> Operator:
    """Rolling list of the last ``n`` values."""

    def step(state: List[Any], value: Any) -> List[Any]:
        return [*state, value][-n:]

    def op(source: Observable) -> Observable:
        return source.pipe(ops.scan(step, []))

    return op


class _GrowBuffer:
    """Append-only float array with amortized-doubling capacity."""

    def __init__(self, channels: int, initial_capacity: int = 1024):
        self._data = np.zeros((initial_capacity, channels), np.float32)
        self._len = 0

    def extend(self, rows: np.ndarray) -> None:
        needed = self._len + rows.shape[0]
        capacity = self._data.shape[0]
        if needed > capacity:
            while capacity < needed:
                capacity *= 2
            grown = np.zeros((capacity, self._data.shape[1]), np.float32)
            grown[: self._len] = self._data[: self._len]
            self._data = grown
        self._data[self._len : needed] = rows
        self._len = needed

    def view(self) -> np.ndarray:
        return self._data[: self._len]


def _split(value) -> Tuple[Annotation, Optional[SlidingWindowFeature]]:
    prediction = value[0]
    waveform = value[1] if len(value) > 1 else None
    return prediction, waveform


class _UnboundedAccumulator:
    """Joins the prediction/audio stream into one ever-growing pair."""

    def __init__(self, duration: float, step: float, patch_collar: float):
        self.duration = duration
        self.step = step
        self.patch_collar = patch_collar
        self._annotation: Optional[Annotation] = None
        self._audio: Optional[_GrowBuffer] = None
        self._window: Optional[SlidingWindow] = None
        self._real_time = 0.0

    def push(self, value) -> Tuple[Annotation, Optional[SlidingWindowFeature], float]:
        prediction, waveform = _split(value)
        if self._annotation is None:
            self._annotation = prediction
            self._real_time = self.duration
        else:
            self._annotation = self._annotation.update(prediction).support(
                self.patch_collar
            )
            self._real_time += self.step

        audio = None
        if waveform is not None:
            if self._audio is None:
                self._audio = _GrowBuffer(waveform.data.shape[1])
                self._window = waveform.sliding_window
            self._audio.extend(waveform.data)
            audio = SlidingWindowFeature(self._audio.view(), self._window)
        return self._annotation, audio, self._real_time


def accumulate_output(
    duration: float, step: float, patch_collar: float = 0.05
) -> Operator:
    """Accumulate predictions and audio for the whole stream (O(N) space,
    amortized O(1) per hop)."""
    acc = _UnboundedAccumulator(duration, step, patch_collar)

    def op(source: Observable) -> Observable:
        return source.pipe(ops.map(acc.push))

    return op


class _RollingWindowJoiner:
    """Keeps only the most recent plot-window of predictions + audio."""

    def __init__(
        self,
        duration: float,
        step: float,
        latency: float,
        sample_rate: int,
        patch_collar: float,
    ):
        self.duration = duration
        self.step = step
        self.latency = latency
        self.sample_rate = sample_rate
        self.patch_collar = patch_collar
        self._annotation: Optional[Annotation] = None
        self._blocks: List[np.ndarray] = []  # recent audio, oldest first
        self._real_time = 0.0
        # first emission covers [0, duration + step - latency)
        self._first_samples = int(round((duration + step - latency) * sample_rate))
        self._max_samples = int(round((duration + step) * sample_rate))

    def push(self, value) -> Tuple[Annotation, Optional[SlidingWindowFeature], float]:
        prediction, waveform = _split(value)
        first = self._annotation is None
        self._real_time = self.duration if first else self._real_time + self.step
        window_start = max(0.0, self._real_time - self.latency - self.duration)

        if first:
            self._annotation = prediction
        else:
            self._annotation = self._annotation.update(prediction).support(
                self.patch_collar
            )
            if window_start > 0:
                self._annotation = self._annotation.extrude(Segment(0, window_start))

        audio = None
        if waveform is not None:
            new = waveform.data[: self._first_samples] if first else waveform.data
            self._blocks.append(np.asarray(new, np.float32))
            data = np.concatenate(self._blocks, axis=0)
            if data.shape[0] > self._max_samples:
                data = data[-self._max_samples :]
                self._blocks = [data]
            resolution = 1.0 / self.sample_rate
            sw = SlidingWindow(start=window_start, duration=resolution, step=resolution)
            audio = SlidingWindowFeature(data, sw)
        return self._annotation, audio, self._real_time


def buffer_output(
    duration: float,
    step: float,
    latency: float,
    sample_rate: int,
    patch_collar: float = 0.05,
) -> Operator:
    """Rolling fixed-horizon output view for live visualization."""
    joiner = _RollingWindowJoiner(duration, step, latency, sample_rate, patch_collar)

    def op(source: Observable) -> Observable:
        return source.pipe(ops.map(joiner.push))

    return op
