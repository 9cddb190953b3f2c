"""Audio sources: push-based producers of raw sample blocks (port of
``diart_tpu/runtime/sources.py``).

Sources produce host audio (numpy blocks); the pipeline copies each batch
of chunks to its device. ``sounddevice``, ``websockets`` and ``torchaudio``
are imported only by the sources that need them.

Parity targets in diart's ``sources.py``: file source with
zero padding and fixed block size (``:50-135``), microphone capture
(``:138-201``, requires ``sounddevice``), websocket server source
(``:204-271``), and a generic iterator source replacing the torchaudio
``StreamReader`` variants (``:274-322``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from queue import SimpleQueue
from typing import Iterable, Optional, Text, Tuple, Union

import numpy as np

from .. import utils
from ..audio import AudioLoader, FilePath
from .rx import Subject

__all__ = [
    "AudioSource",
    "FileAudioSource",
    "FFmpegAudioSource",
    "IteratorAudioSource",
    "MicrophoneAudioSource",
    "WebSocketAudioSource",
    "TorchStreamAudioSource",
    "AppleDeviceAudioSource",
]


class AudioSource(ABC):
    """A source of audio that streams sample blocks via ``self.stream``."""

    def __init__(self, uri: Text, sample_rate: int):
        self.uri = uri
        self.sample_rate = sample_rate
        self.stream = Subject()

    @property
    def duration(self) -> Optional[float]:
        """Stream duration if known, else None."""
        return None

    @abstractmethod
    def read(self):
        """Start reading and pushing samples through the stream (blocking)."""

    @abstractmethod
    def close(self):
        """Stop reading and close open handles."""

    def _emit(self, block: np.ndarray) -> bool:
        """Push one block, routing downstream (pipeline) exceptions to
        ``stream.on_error``. Returns False when the read loop must stop.
        Every source's read loop uses this so the error contract cannot
        silently diverge between sources (the websocket source once
        omitted it and hung ``read()`` forever on a decode error)."""
        try:
            self.stream.on_next(block)
            return True
        except BaseException as e:
            self.stream.on_error(e)
            return False


class FileAudioSource(AudioSource):
    """Streams a file in fixed-size blocks with optional zero padding
    (``sources.py:50-135``)."""

    def __init__(
        self,
        file: FilePath,
        sample_rate: int,
        padding: Tuple[float, float] = (0.0, 0.0),
        block_duration: float = 0.5,
    ):
        super().__init__(Path(file).stem, sample_rate)
        self.loader = AudioLoader(self.sample_rate, mono=True)
        self._duration = self.loader.get_duration(file)
        self.file = file
        self.block_size = int(np.rint(block_duration * self.sample_rate))
        self.padding_start, self.padding_end = padding
        self.is_closed = False

    @property
    def duration(self) -> Optional[float]:
        return self.padding_start + self._duration + self.padding_end

    def read(self):
        waveform = self.loader.load(self.file)  # (1, samples)
        if self.padding_start > 0:
            pad = int(np.rint(self.padding_start * self.sample_rate))
            waveform = np.concatenate(
                [np.zeros((waveform.shape[0], pad), np.float32), waveform], axis=1
            )
        if self.padding_end > 0:
            pad = int(np.rint(self.padding_end * self.sample_rate))
            waveform = np.concatenate(
                [waveform, np.zeros((waveform.shape[0], pad), np.float32)], axis=1
            )

        num_samples = waveform.shape[1]
        for start in range(0, num_samples, self.block_size):
            if self.is_closed:
                break
            block = waveform[:, start : start + self.block_size]
            if block.shape[1] < self.block_size:
                block = np.concatenate(
                    [
                        block,
                        np.zeros(
                            (block.shape[0], self.block_size - block.shape[1]),
                            np.float32,
                        ),
                    ],
                    axis=1,
                )
            if not self._emit(block):
                break
        self.stream.on_completed()
        self.close()

    def close(self):
        self.is_closed = True


class IteratorAudioSource(AudioSource):
    """Wraps any iterator of (1, n) float32 blocks as a source — the generic
    replacement for the reference's torchaudio ``StreamReader`` sources
    (``sources.py:274-322``) and the backbone of hermetic tests."""

    def __init__(
        self,
        uri: Text,
        sample_rate: int,
        blocks: Iterable[np.ndarray],
        total_duration: Optional[float] = None,
    ):
        super().__init__(uri, sample_rate)
        self._blocks = blocks
        self._duration = total_duration
        self.is_closed = False

    @property
    def duration(self) -> Optional[float]:
        return self._duration

    def read(self):
        for block in self._blocks:
            if self.is_closed:
                break
            if not self._emit(np.atleast_2d(block)):
                break
        self.stream.on_completed()
        self.close()

    def close(self):
        self.is_closed = True


class FFmpegAudioSource(AudioSource):
    """Streaming decode of arbitrary containers, URLs and devices through an
    ``ffmpeg`` subprocess — closes the capability gap of the reference's
    torchaudio ``StreamReader`` sources (``sources.py:274-322``) with zero
    Python dependencies: ffmpeg decodes ANY input it understands (mp3/ogg/
    mp4/rtmp/http/hls/...) to mono float32 PCM on its stdout, which is
    re-blocked and pushed through the reactive stream.

    Parameters
    ----------
    input_spec: anything ffmpeg accepts after ``-i`` — a path, a URL, or a
        device specifier (combine with ``extra_input_args`` such as
        ``["-f", "avfoundation"]`` for capture devices).
    sample_rate: output rate; ffmpeg resamples on the fly.
    block_duration: seconds per emitted block.
    extra_input_args: ffmpeg arguments inserted BEFORE ``-i`` (format/device
        selection, ``-re`` for paced playback, seeking, ...).
    binary: the ffmpeg executable (default: ``ffmpeg`` on PATH).
    """

    def __init__(
        self,
        input_spec: Union[Text, Path],
        sample_rate: int,
        block_duration: float = 0.5,
        extra_input_args: Optional[list] = None,
        binary: Text = "ffmpeg",
    ):
        import shutil

        if shutil.which(binary) is None:
            raise FileNotFoundError(
                f"{binary!r} not found on PATH — FFmpegAudioSource decodes "
                f"through the ffmpeg CLI; install ffmpeg or wrap your own "
                f"decoder in IteratorAudioSource"
            )
        spec = str(input_spec)
        uri = Path(spec).stem if "://" not in spec else spec.rstrip("/").split("/")[-1]
        super().__init__(uri or spec, sample_rate)
        self.input_spec = spec
        self.binary = binary
        self.extra_input_args = list(extra_input_args or [])
        self.block_size = int(np.rint(block_duration * sample_rate))
        self._process = None
        self.is_closed = False
        self._duration_cache: Union[bool, None, float] = False  # False=unprobed

    @property
    def duration(self) -> Optional[float]:
        """Container duration via ffprobe when available (None for live
        streams/devices or when ffprobe is missing). Probed once — the
        ffprobe subprocess costs up to its 30 s timeout, and callers may
        touch the property repeatedly."""
        if self._duration_cache is False:
            self._duration_cache = self._probe_duration()
        return self._duration_cache

    def _probe_duration(self) -> Optional[float]:
        import shutil
        import subprocess

        probe = self.binary[:-6] + "ffprobe" if self.binary.endswith("ffmpeg") else "ffprobe"
        if shutil.which(probe) is None or "://" in self.input_spec:
            return None
        try:
            out = subprocess.run(
                [
                    probe, "-v", "error", "-show_entries", "format=duration",
                    "-of", "default=noprint_wrappers=1:nokey=1", self.input_spec,
                ],
                capture_output=True, text=True, timeout=30,
            )
            return float(out.stdout.strip())
        except (ValueError, subprocess.SubprocessError, OSError):
            return None

    def _command(self) -> list:
        return (
            [self.binary, "-hide_banner", "-loglevel", "error", "-nostdin"]
            + self.extra_input_args
            + [
                "-i", self.input_spec,
                "-f", "f32le", "-acodec", "pcm_f32le",
                "-ac", "1", "-ar", str(self.sample_rate),
                "pipe:1",
            ]
        )

    def read(self):
        import subprocess
        import threading
        from collections import deque

        bytes_per_block = 4 * self.block_size
        self._process = subprocess.Popen(
            self._command(), stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
        # Drain stderr continuously on a thread, keeping a bounded tail
        # for the error message: a chatty ffmpeg (repeated decode errors
        # on a corrupt container) otherwise fills the ~64 KB OS pipe
        # buffer, blocks writing stderr, and stops producing stdout —
        # deadlocking the read loop below forever.
        stderr_tail: deque = deque(maxlen=64)

        def _drain():
            for line in self._process.stderr:
                stderr_tail.append(line)

        drainer = threading.Thread(target=_drain, daemon=True)
        drainer.start()
        try:
            while not self.is_closed:
                data = self._process.stdout.read(bytes_per_block)
                if not data:
                    break
                # trailing partial sample (truncated stream) is dropped
                samples = np.frombuffer(
                    data[: len(data) - len(data) % 4], np.float32
                )
                if samples.size == 0:
                    break
                if not self._emit(samples[None, :]):
                    break
        finally:
            code = self._terminate()
            drainer.join(timeout=2.0)
            if code not in (None, 0) and not self.is_closed:
                err = b"".join(stderr_tail)
                self.stream.on_error(
                    RuntimeError(
                        f"ffmpeg exited with {code}: "
                        f"{err.decode(errors='replace').strip()}"
                    )
                )
            else:
                self.stream.on_completed()
            self.close()

    def _terminate(self) -> Optional[int]:
        import subprocess

        if self._process is None:
            return None
        if self._process.poll() is None:
            self._process.terminate()
            try:
                self._process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._process.kill()
                self._process.wait()
        return self._process.returncode

    def close(self):
        self.is_closed = True
        if self._process is not None and self._process.poll() is None:
            self._process.terminate()


class MicrophoneAudioSource(AudioSource):
    """Local microphone capture (requires ``sounddevice``;
    ``sources.py:138-201``)."""

    def __init__(
        self,
        block_duration: float = 0.5,
        device: Optional[Union[int, Text, Tuple[int, Text]]] = None,
    ):
        try:
            import sounddevice as sd
        except ImportError as e:
            raise ImportError(
                "microphone capture requires `sounddevice`, which is not installed"
            ) from e
        best_sample_rate = None
        for sr in (16000, 32000, 44100, 48000):
            try:
                sd.check_input_settings(device=device, samplerate=sr)
            except Exception:
                continue
            best_sample_rate = sr
            break
        if best_sample_rate is None:
            # fall back to the device's own default rate before giving a
            # descriptive error (8 kHz telephony hardware etc. rejects
            # every probed rate)
            try:
                info = sd.query_devices(device, "input")
                candidate = int(round(info["default_samplerate"]))
                sd.check_input_settings(device=device, samplerate=candidate)
                best_sample_rate = candidate
            except Exception as e:
                raise RuntimeError(
                    f"input device {device!r} accepts none of the probed "
                    "sample rates (16000/32000/44100/48000) nor its own "
                    "default rate"
                ) from e
        super().__init__(f"input_device:{device}", best_sample_rate)
        self.block_size = int(np.rint(block_duration * self.sample_rate))
        self._queue = SimpleQueue()
        self._mic_stream = sd.InputStream(
            channels=1,
            samplerate=self.sample_rate,
            latency=0,
            blocksize=self.block_size,
            callback=self._read_callback,
            device=device,
        )

    def _read_callback(self, samples, *args):
        self._queue.put_nowait(samples[:, [0]].T)

    def read(self):
        self._mic_stream.start()
        while not self._mic_stream.closed:
            block = self._queue.get()  # blocks until the callback posts
            if block is None:  # close() sentinel
                break
            if not self._emit(block):
                break
        self.stream.on_completed()
        self.close()

    def close(self):
        if not self._mic_stream.closed:
            self._mic_stream.stop()
            self._mic_stream.close()
        # unblock a reader waiting on the queue
        self._queue.put_nowait(None)


class WebSocketAudioSource(AudioSource):
    """Audio over a websocket: each text frame is a base64 float32 block
    (``sources.py:204-271``; wire format ``utils.py:56-66``). One client at a
    time — for multiplexed many-client serving use
    ``diart_tpu_torch.runtime.server.StreamingServer``."""

    def __init__(
        self,
        sample_rate: int,
        host: Text = "127.0.0.1",
        port: int = 7007,
        key: Optional[Union[Text, Path]] = None,
        certificate: Optional[Union[Text, Path]] = None,
    ):
        super().__init__(f"{host}:{port}", sample_rate)
        self.host = host
        self.port = port
        self.key = key
        self.certificate = certificate
        self._client = None
        self._loop = None
        self._server = None
        self._stop_event = None
        self._worker = None

    def _handle(self, websocket):
        import asyncio

        import websockets

        async def handler():
            self._client = websocket
            loop = asyncio.get_running_loop()
            try:
                async for message in websocket:
                    # decode + the full synchronous pipeline run on the
                    # worker thread: the first hop may build the kernels
                    # for seconds, and blocking the event loop that long
                    # would fail the client's keepalive pings (dropping
                    # the connection mid-stream)
                    await loop.run_in_executor(
                        self._worker, self._push_message, message
                    )
            except websockets.exceptions.ConnectionClosed:
                # client went away: keep serving subsequent clients, as
                # the reference source does (sources.py:246-254)
                return
            except Exception as e:
                # decode or pipeline failure: the stream errors and the
                # source shuts down — the same contract every other
                # source's read loop implements via _emit
                self.stream.on_error(e)
                self.close()

        return handler()

    def _push_message(self, message):
        self.stream.on_next(utils.decode_audio(message))

    def read(self):
        import asyncio
        from concurrent.futures import ThreadPoolExecutor

        import websockets

        self._worker = ThreadPoolExecutor(1, "diart-ws-source")

        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop_event = asyncio.Event()
            ssl_context = None
            if self.certificate is not None:
                import ssl

                ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ssl_context.load_cert_chain(self.certificate, keyfile=self.key)
            async with websockets.serve(
                lambda ws: self._handle(ws), self.host, self.port, ssl=ssl_context
            ) as server:
                self._server = server
                await self._stop_event.wait()

        try:
            asyncio.run(main())
        finally:
            self._worker.shutdown(wait=False)
            self.stream.on_completed()

    def close(self):
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)

    def send(self, message: Text):
        """Send a message back to the current client (server->client RTTM)."""
        if self._client is not None and self._loop is not None and message:
            import asyncio

            asyncio.run_coroutine_threadsafe(
                self._client.send(message), self._loop
            )


class TorchStreamAudioSource(AudioSource):
    """Streaming decode of arbitrary containers/devices via torchaudio's
    StreamReader (parity: ``sources.py:274-322``; optional dependency).
    Without torchaudio, wrap any block iterator in
    :class:`IteratorAudioSource` instead."""

    def __init__(
        self,
        uri: Text,
        sample_rate: int,
        streamer=None,
        stream_index: Optional[int] = None,
        block_duration: float = 0.5,
    ):
        try:
            from torchaudio.io import StreamReader  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "TorchStreamAudioSource requires `torchaudio`; for generic "
                "streams use IteratorAudioSource"
            ) from e
        if streamer is None:
            raise ValueError(
                "TorchStreamAudioSource needs a torchaudio StreamReader as "
                "`streamer` (e.g. StreamReader(src=uri)); for generic "
                "inputs use FFmpegAudioSource or IteratorAudioSource"
            )
        super().__init__(uri, sample_rate)
        self.block_size = int(np.rint(block_duration * self.sample_rate))
        self._streamer = streamer
        self._streamer.add_basic_audio_stream(
            frames_per_chunk=self.block_size,
            stream_index=stream_index,
            format="fltp",
            sample_rate=self.sample_rate,
        )
        self.is_closed = False

    def read(self):
        for item in self._streamer.stream():
            if self.is_closed:
                break
            chunk = np.mean(item[0].numpy(), axis=1, keepdims=True).T
            if not self._emit(chunk):
                break
        self.stream.on_completed()
        self.close()

    def close(self):
        self.is_closed = True


class AppleDeviceAudioSource(TorchStreamAudioSource):
    """macOS avfoundation capture device (parity: ``sources.py:312-322``)."""

    def __init__(
        self,
        sample_rate: int,
        device: str = "0:0",
        stream_index: int = 0,
        block_duration: float = 0.5,
    ):
        from torchaudio.io import StreamReader

        streamer = StreamReader(device, format="avfoundation")
        super().__init__(
            f"apple_input_device:{device}",
            sample_rate,
            streamer,
            stream_index,
            block_duration,
        )
