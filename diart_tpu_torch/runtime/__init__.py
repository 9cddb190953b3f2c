"""diart's runtime on the port (port of ``diart_tpu/runtime``): sources,
the streaming driver, benchmarks, sinks and stream operators.
``StreamingServer`` lives in :mod:`diart_tpu_torch.runtime.server` (it needs
``websockets`` only to serve)."""

from .rx import Observable, Observer, Subject, ops
from .sources import (
    AppleDeviceAudioSource,
    AudioSource,
    FFmpegAudioSource,
    FileAudioSource,
    IteratorAudioSource,
    MicrophoneAudioSource,
    TorchStreamAudioSource,
    WebSocketAudioSource,
)
from .sinks import (
    PredictionAccumulator,
    RTTMWriter,
    StreamingPlot,
    WindowClosedException,
)
from .inference import Benchmark, Parallelize, StreamingInference
from .operators import (
    SlidingChunker,
    accumulate_output,
    buffer_output,
    buffer_slide,
    rearrange_audio_stream,
)

__all__ = [
    "Observable",
    "Observer",
    "Subject",
    "ops",
    "AudioSource",
    "FFmpegAudioSource",
    "FileAudioSource",
    "IteratorAudioSource",
    "MicrophoneAudioSource",
    "WebSocketAudioSource",
    "TorchStreamAudioSource",
    "AppleDeviceAudioSource",
    "PredictionAccumulator",
    "RTTMWriter",
    "StreamingPlot",
    "WindowClosedException",
    "Benchmark",
    "Parallelize",
    "StreamingInference",
    "SlidingChunker",
    "rearrange_audio_stream",
    "buffer_slide",
    "accumulate_output",
    "buffer_output",
]
