"""Host utilities of the port (a copy of ``diart_tpu/utils.py``): the
wall-clock ``Chronometer``, the base64 audio codecs of the websocket wire,
the padding math of file streaming, the pipeline lookup and the notebook
plot helpers (matplotlib is imported only when one is called)."""

from __future__ import annotations

import base64
import time
from typing import Iterator, Optional, Union

import numpy as np

__all__ = [
    "Chronometer",
    "decode_audio",
    "decode_audio_int16",
    "encode_audio",
    "encode_audio_int16",
    "get_padding_left",
    "get_padding_right",
    "get_pipeline_class",
    "parse_hf_token_arg",
    "repeat_label",
    "visualize_annotation",
    "visualize_feature",
]


class Chronometer:
    """Wall-clock profiler for per-unit latencies (mean ± std report)."""

    def __init__(self, unit: str, progress_bar=None):
        self.unit = unit
        self.progress_bar = progress_bar
        self.current_start_time: Optional[float] = None
        self.history = []

    @property
    def is_running(self) -> bool:
        return self.current_start_time is not None

    def start(self):
        self.current_start_time = time.monotonic()

    def stop(self, do_count: bool = True):
        assert self.current_start_time is not None, "stop() called before start()"
        elapsed = time.monotonic() - self.current_start_time
        self.current_start_time = None
        if do_count:
            self.history.append(elapsed)

    def report(self):
        if not self.history:
            return
        print_fn = print if self.progress_bar is None else self.progress_bar.write
        print_fn(
            f"Took {np.mean(self.history):.3f} "
            f"(+/-{np.std(self.history):.3f}) seconds/{self.unit} "
            f"-- ran {len(self.history)} times"
        )


def encode_audio(waveform: np.ndarray) -> str:
    """float32 samples -> base64 (the websocket wire format)."""
    return base64.b64encode(waveform.astype(np.float32).tobytes()).decode("utf-8")


def decode_audio(data: str) -> np.ndarray:
    """base64 -> (1, samples) float32."""
    samples = np.frombuffer(base64.decodebytes(data.encode("utf-8")), dtype=np.float32)
    return samples.reshape(1, -1)


def encode_audio_int16(waveform: np.ndarray) -> str:
    """float32 samples -> base64 of int16 PCM: HALF the wire bytes of the
    reference's float32 format (``encode_audio``). Quantization is the same
    clip-scale used device-side by ``quantize_transfer`` (exact to
    1/32768); a server told via the ``{"format": "int16"}`` handshake
    decodes with :func:`decode_audio_int16`."""
    if np.issubdtype(np.asarray(waveform).dtype, np.integer):
        pcm = np.asarray(waveform, np.int16)
    else:
        pcm = np.clip(
            np.asarray(waveform, np.float32) * 32768.0, -32768, 32767
        ).astype(np.int16)
    return base64.b64encode(pcm.tobytes()).decode("utf-8")


def decode_audio_int16(data: str) -> np.ndarray:
    """base64 -> (1, samples) int16 PCM (no float conversion: an
    int16-transfer server ships these bytes to the device as-is and
    dequantizes there)."""
    samples = np.frombuffer(base64.decodebytes(data.encode("utf-8")), dtype=np.int16)
    return samples.reshape(1, -1)


def get_padding_left(stream_duration: float, chunk_duration: float) -> float:
    """Zero-padding needed so short streams still fill one chunk."""
    if stream_duration < chunk_duration:
        return chunk_duration - stream_duration
    return 0.0


def get_padding_right(latency: float, step: float) -> float:
    """Trailing padding so the last `latency - step` seconds get emitted."""
    return latency - step


def get_pipeline_class(class_name: str) -> type:
    """The port's pipeline class (or any block) of that name."""
    from . import blocks

    pipeline_class = getattr(blocks, class_name, None)
    assert pipeline_class is not None, f"Pipeline '{class_name}' doesn't exist"
    return pipeline_class


def parse_hf_token_arg(hf_token: Union[bool, str]) -> Union[bool, str]:
    if isinstance(hf_token, bool):
        return hf_token
    if hf_token.lower() == "true":
        return True
    if hf_token.lower() == "false":
        return False
    return hf_token


def repeat_label(label: str) -> Iterator[str]:
    while True:
        yield label


def visualize_feature(duration=None):
    """Notebook helper: plot a SlidingWindowFeature (diart's
    ``utils.py:91-102``); matplotlib is imported on the call."""

    def apply(feature):
        import matplotlib.pyplot as plt

        sw = feature.sliding_window
        times = sw.start + np.arange(feature.data.shape[0]) * sw.step
        plt.figure(figsize=(8, 2))
        plt.plot(times, feature.data)
        if duration is not None:
            plt.xlim(times[-1] - duration, times[-1])
        plt.tight_layout()
        plt.show()

    return apply


def visualize_annotation(duration=None):
    """Notebook helper: plot an Annotation timeline (diart's
    ``utils.py:105-117``); matplotlib is imported on the call."""

    def apply(annotation):
        import matplotlib.pyplot as plt

        labels = annotation.labels()
        plt.figure(figsize=(8, 2))
        for i, label in enumerate(labels):
            for seg in annotation.label_timeline(label):
                plt.plot([seg.start, seg.end], [i, i], lw=8)
        extent = annotation.get_timeline().extent()
        if duration is not None:
            plt.xlim(extent.end - duration, extent.end)
        plt.yticks(range(len(labels)), labels)
        plt.tight_layout()
        plt.show()

    return apply
