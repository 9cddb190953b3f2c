"""Output sinks: RTTM writer, accumulator, live plot (port of
``diart_tpu/runtime/sinks.py``).

Covers the sink surface of diart's ``sinks.py`` (RTTM
writer ``:25-57``, accumulator ``:59-88``, live plot ``:91-177``) with a
different mechanical design: both turn collectors derive from a shared
finalizing observer and keep the canonical annotation *in memory* — the
writer tees raw turns to disk per hop purely for crash safety, and the
final patched file is rewritten from memory rather than re-parsed from the
partial file. matplotlib is imported only when a :class:`StreamingPlot`
is built.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Text, Tuple, Union

from ..core.annotation import Annotation, load_rttm
from ..core.segment import Segment, SlidingWindowFeature
from ..metrics import DiarizationErrorRate
from .rx import Observer

__all__ = [
    "WindowClosedException",
    "RTTMWriter",
    "PredictionAccumulator",
    "StreamingPlot",
]


class WindowClosedException(Exception):
    pass


class _TurnCollector(Observer):
    """Base sink: folds the stream of (annotation, ...) values into one
    merged annotation, finalizing (gap-patching) on completion or error."""

    def __init__(self, uri: Optional[Text], patch_collar: float):
        self.uri = uri
        self.patch_collar = patch_collar
        self._merged: Optional[Annotation] = None

    @staticmethod
    def _annotation_of(value: Union[Tuple, Annotation]) -> Annotation:
        if isinstance(value, tuple):
            value = value[0]
        if not isinstance(value, Annotation):
            raise ValueError(f"expected tuple or Annotation, but got {type(value)}")
        return value

    def _fold(self, prediction: Annotation) -> Annotation:
        prediction.uri = self.uri
        if self._merged is None:
            self._merged = prediction
        else:
            self._merged.update(prediction)
        return self._merged

    def _finalized(self) -> Annotation:
        """Merged annotation with same-speaker turns closer than
        ``patch_collar`` joined."""
        if self._merged is None:
            return Annotation(self.uri)
        self._merged = self._merged.support(self.patch_collar)
        return self._merged

    def on_next(self, value):
        self._fold(self._annotation_of(value))

    def on_error(self, error: Exception):
        self.finalize()

    def on_completed(self):
        self.finalize()

    def finalize(self):
        self._finalized()


class PredictionAccumulator(_TurnCollector):
    """In-memory accumulation; ``get_prediction`` returns the patched whole."""

    def __init__(self, uri: Optional[Text] = None, patch_collar: float = 0.05):
        super().__init__(uri, patch_collar)

    def get_prediction(self) -> Annotation:
        return self._finalized()

    # kept for API familiarity with the reference sink
    def patch(self):
        self.finalize()


class RTTMWriter(_TurnCollector):
    """Streams RTTM lines to disk per hop (so output survives crashes) and
    rewrites the file patched from the in-memory annotation on completion
    or error."""

    def __init__(self, uri: Text, path: Union[Path, Text], patch_collar: float = 0.05):
        super().__init__(uri, patch_collar)
        self.path = Path(path).expanduser()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            self.path.unlink()

    def on_next(self, value):
        prediction = self._annotation_of(value)
        prediction.uri = self.uri
        with open(self.path, "a") as f:
            prediction.write_rttm(f)
        self._fold(prediction)

    def finalize(self):
        # If this process never saw an on_next (e.g. crash before the first
        # hop) there is nothing to patch and possibly no file to rewrite.
        if self._merged is None and not self.path.exists():
            return
        with open(self.path, "w") as f:
            self._finalized().write_rttm(f)

    # kept for API familiarity with the reference sink
    def patch(self):
        self.finalize()


class StreamingPlot(Observer):
    """Live matplotlib view of predictions + audio, optionally aligned to a
    reference annotation via optimal mapping (``sinks.py:91-177``).
    Expects the output of the ``buffer_output`` operator."""

    def __init__(
        self,
        duration: float,
        latency: float,
        visualization: str = "slide",
        reference: Optional[Union[Path, Text]] = None,
    ):
        super().__init__()
        assert visualization in ("slide", "accumulate")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.visualization = visualization
        self.reference = reference
        if self.reference is not None:
            self.reference = list(load_rttm(reference).values())[0]
        self.window_duration = duration
        self.latency = latency
        self.figure, self.axs, self.num_axs = None, None, -1
        self.window_closed = False

    def _on_window_closed(self, event):
        self.window_closed = True

    def _init_figure(self):
        self.num_axs = 2 + (1 if self.reference is not None else 0)
        self.figure, self.axs = self._plt.subplots(
            self.num_axs, 1, figsize=(10, 2 * self.num_axs)
        )
        self.figure.canvas.mpl_connect("close_event", self._on_window_closed)

    def get_plot_bounds(self, real_time: float) -> Segment:
        end_time = real_time - self.latency
        start_time = 0.0
        if self.visualization == "slide":
            start_time = max(0.0, end_time - self.window_duration)
        return Segment(start_time, end_time)

    def _plot_annotation(self, annotation: Annotation, ax, bounds: Segment):
        labels = annotation.labels()
        for i, label in enumerate(labels):
            for seg in annotation.label_timeline(label):
                c = seg & bounds
                if c:
                    ax.plot([c.start, c.end], [i, i], lw=8)
        ax.set_xlim(bounds.start, bounds.end)
        ax.set_yticks(range(len(labels)))
        ax.set_yticklabels(labels)

    def on_next(self, values: Tuple[Annotation, SlidingWindowFeature, float]):
        if self.window_closed:
            raise WindowClosedException
        prediction, waveform, real_time = values
        if self.figure is None:
            self._init_figure()
        for ax in self.axs:
            ax.clear()
        bounds = self.get_plot_bounds(real_time)

        if self.reference is not None:
            metric = DiarizationErrorRate()
            mapping = metric.optimal_mapping(self.reference, prediction)
            prediction = prediction.rename_labels(mapping=mapping, copy=True)

        self._plot_annotation(prediction, self.axs[0], bounds)
        self.axs[0].set_title("Output")

        if waveform is not None:
            sw = waveform.sliding_window
            import numpy as np

            times = sw.start + np.arange(waveform.data.shape[0]) * sw.step
            self.axs[1].plot(times, waveform.data[:, 0], lw=0.5)
            self.axs[1].set_xlim(bounds.start, bounds.end)
        self.axs[1].set_title("Audio")

        if self.num_axs == 3:
            self._plot_annotation(self.reference, self.axs[2], bounds)
            self.axs[2].set_title("Reference")

        self._plt.tight_layout()
        self.figure.canvas.draw()
        self.figure.canvas.flush_events()
        self._plt.pause(0.05)
