"""Audio file loading without heavyweight dependencies (a copy of
``diart_tpu/audio.py``).

diart delegates decoding to torchaudio (its ``audio.py``). This loader
decodes mono WAV with the native decoder (``native/wavio.cpp``) and, where
that declines a file, with numpy (PCM 8/16/24/32-bit and IEEE float); other
containers go to ``torchaudio`` or ``soundfile`` when installed. It resamples
with the polyphase resampler (:mod:`diart_tpu_torch.ops.resample`) on the
host: a loaded file is host audio.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

from .native import wav_decode_mono
from .ops.resample import resample

FilePath = Union[str, Path]

__all__ = ["AudioLoader", "FilePath", "read_wav", "write_wav", "WavBlockReader"]


def _decode_pcm(
    raw: bytes, audio_format: int, bits: int, sub_format: "int | None" = None
) -> np.ndarray:
    """Raw WAV sample bytes -> interleaved float32 in [-1, 1]."""
    # a truncated final sample (interrupted download, data size > file
    # size) decodes the whole frames instead of raising in frombuffer
    bytes_per = max(1, bits // 8)
    if len(raw) % bytes_per:
        raw = raw[: len(raw) - (len(raw) % bytes_per)]
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the SubFormat GUID carries the real
        # format code (1 = PCM, 3 = float). Without it (short fmt chunk),
        # fall back to the 32-bit-means-float heuristic.
        audio_format = (
            sub_format if sub_format is not None else (3 if bits == 32 else 1)
        )
    if audio_format == 3:
        if bits == 64:
            return np.frombuffer(raw, dtype="<f8").astype(np.float32)
        return np.frombuffer(raw, dtype="<f4").astype(np.float32)
    if audio_format in (1, 0xFFFE):
        if bits == 16:
            return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        if bits == 8:
            return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        if bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            return ints.astype(np.float32) / float(1 << 23)
        if bits == 32:
            return np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        raise ValueError(f"unsupported PCM bit depth {bits}")
    raise ValueError(f"unsupported WAV format code {audio_format}")


def _parse_fmt_chunk(buf: bytes, filepath) -> tuple:
    """Unpack a fmt chunk payload, raising ValueError (never struct.error)
    on truncated chunks so callers' streamable-WAV probes can fall back.
    Returns the 6 standard fields plus the extensible SubFormat code
    (None when the chunk has no extension)."""
    if len(buf) < 16:
        raise ValueError(f"{filepath}: truncated fmt chunk ({len(buf)} bytes)")
    fields = struct.unpack("<HHIIHH", buf[:16])
    sub_format = None
    if fields[0] == 0xFFFE and len(buf) >= 26:
        # extension: cbSize(2) validBits(2) channelMask(4) GUID(16);
        # the GUID's leading two bytes are the true format code
        sub_format = struct.unpack("<H", buf[24:26])[0]
    return fields + (sub_format,)


def _read_fmt_chunk(f, size: int, filepath) -> tuple:
    """Read a fmt chunk of declared ``size`` without over-reading (legacy
    14-byte chunks would otherwise desynchronize the chunk walk) and skip
    any remainder plus the RIFF pad byte."""
    take = min(size, 40)
    fmt = _parse_fmt_chunk(f.read(take), filepath)
    rest = size - take + (size & 1)
    if rest > 0:
        f.read(rest)
    return fmt


def read_wav(filepath: FilePath) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> ((channels, samples) float32 in [-1, 1], rate)."""
    with open(filepath, "rb") as f:
        preamble = f.read(12)
        if len(preamble) < 12:
            raise ValueError(f"{filepath} is too short to be a WAV file")
        riff, _, wave_id = struct.unpack("<4sI4s", preamble)
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{filepath} is not a RIFF/WAVE file")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"{filepath}: no data chunk found")
            chunk_id, size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = _read_fmt_chunk(f, size, filepath)
            elif chunk_id == b"data":
                raw = f.read(size)
                break
            else:
                f.read(size + (size & 1))
        if fmt is None:
            raise ValueError(f"{filepath}: missing fmt chunk")
        audio_format, channels, rate, _, _, bits, sub_format = fmt
        if channels == 0:
            raise ValueError(f"{filepath}: zero channels in fmt chunk")
        if audio_format == 3 and bits not in (32, 64):
            raise ValueError(f"{filepath}: IEEE-float WAV must be 32-bit, got {bits}")
        data = _decode_pcm(raw, audio_format, bits, sub_format)
    usable = (len(data) // channels) * channels
    return data[:usable].reshape(-1, channels).T, rate


class WavBlockReader:
    """Streams mono float32 blocks from a WAV file without loading it fully.

    Used by ``Benchmark(multi_stream=True)`` so corpus-scale batches (dozens
    of 90-minute meetings) never materialize all waveforms in host memory at
    once. Only WAV is streamable; other containers go through the full
    :class:`AudioLoader` decode.
    """

    def __init__(self, path: FilePath):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        # any header defect closes the file and surfaces as ValueError so
        # the streamable-WAV probe in Benchmark can fall back cleanly
        try:
            self._parse_header()
        except ValueError:
            self._file.close()
            raise
        except Exception as e:
            self._file.close()
            raise ValueError(f"{path}: malformed WAV header ({e})") from e

    def _parse_header(self):
        path = self.path
        preamble = self._file.read(12)
        if len(preamble) < 12:
            raise ValueError(f"{path} is too short to be a WAV file")
        riff, _, wave_id = struct.unpack("<4sI4s", preamble)
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        while True:
            header = self._file.read(8)
            if len(header) < 8:
                raise ValueError(f"{path}: no data chunk found")
            chunk_id, size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = _read_fmt_chunk(self._file, size, path)
            elif chunk_id == b"data":
                # streamed/piped WAVs carry placeholder sizes (0 or
                # 0xFFFFFFFF); clamp to the bytes actually present so
                # num_frames plans real audio, not a ~37 h fiction
                import os

                avail = max(
                    0, os.fstat(self._file.fileno()).st_size - self._file.tell()
                )
                self._data_bytes = avail if size in (0, 0xFFFFFFFF) else min(size, avail)
                break
            else:
                self._file.read(size + (size & 1))
        if fmt is None:
            raise ValueError(f"{path}: missing fmt chunk")
        (
            self.format,
            self.channels,
            self.sample_rate,
            _,
            _,
            self.bits,
            self.sub_format,
        ) = fmt
        if (
            self.channels == 0
            or self.bits not in (8, 16, 24, 32)
            or (self.format == 3 and self.bits != 32)
        ):
            raise ValueError(f"{path}: malformed WAV header")
        self._frame_bytes = self.channels * (self.bits // 8)
        self.num_frames = self._data_bytes // self._frame_bytes
        self._read_frames = 0

    def read_block(self, num_frames: int) -> np.ndarray:
        """Next <=num_frames mono samples; empty array at end of file."""
        todo = min(num_frames, self.num_frames - self._read_frames)
        if todo <= 0:
            return np.zeros((0,), np.float32)
        raw = self._file.read(todo * self._frame_bytes)
        self._read_frames += todo
        data = _decode_pcm(raw, self.format, self.bits, self.sub_format)
        usable = (len(data) // self.channels) * self.channels
        frames = data[:usable].reshape(-1, self.channels)
        return frames.mean(axis=1) if self.channels > 1 else frames[:, 0]

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_wav(filepath: FilePath, waveform: np.ndarray, sample_rate: int) -> None:
    """(channels, samples) float32 -> 16-bit PCM WAV."""
    waveform = np.atleast_2d(np.asarray(waveform))
    pcm = np.clip(waveform.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(filepath), "wb") as w:
        w.setnchannels(waveform.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


class AudioLoader:
    """File -> mono float32 waveform at a target sample rate."""

    def __init__(self, sample_rate: int, mono: bool = True):
        self.sample_rate = sample_rate
        self.mono = mono

    def load(self, filepath: FilePath) -> np.ndarray:
        """Returns (channels, samples) — (1, samples) when mono."""
        waveform = None
        rate = None
        if self.mono and str(filepath).lower().endswith(".wav"):
            # native decode + downmix in one pass; None where it declines
            # the file, which numpy then decodes
            decoded = wav_decode_mono(filepath)
            if decoded is not None:
                waveform, rate = decoded
        if waveform is None:
            waveform, rate = self._decode(filepath)
            if self.mono and waveform.shape[0] > 1:
                waveform = waveform.mean(axis=0, keepdims=True)
        if rate != self.sample_rate:
            waveform = resample(torch.from_numpy(np.ascontiguousarray(waveform, np.float32)),
                                rate, self.sample_rate).numpy()
        return waveform.astype(np.float32)

    @staticmethod
    def _decode(filepath: FilePath) -> Tuple[np.ndarray, int]:
        path = Path(filepath)
        if path.suffix.lower() == ".wav":
            return read_wav(path)
        try:
            import torchaudio

            wav, rate = torchaudio.load(str(path))
            return wav.numpy(), rate
        except ImportError:
            pass
        try:
            import soundfile as sf

            data, rate = sf.read(str(path), always_2d=True)
            return data.T.astype(np.float32), rate
        except ImportError as e:
            raise ValueError(
                f"cannot decode {path.suffix} files: install torchaudio or soundfile"
            ) from e

    def get_duration(self, filepath: FilePath) -> float:
        """Duration in seconds, probing metadata only whenever possible.

        A full decode is the LAST resort: duration is queried once per file
        by padding math (``blocks/base.py:get_file_padding``) and again by
        corpus planning (``Benchmark.run_multi_stream``) — decoding a
        90-minute meeting twice just to learn its length would double the
        benchmark's I/O.
        """
        path = Path(filepath)
        if path.suffix.lower() == ".wav":
            try:
                return self._probe_wav_duration(path)
            except ValueError:
                pass  # malformed header: fall through to the decoders
        try:
            import torchaudio

            info = torchaudio.info(str(path))
            if info.num_frames > 0 and info.sample_rate > 0:
                return info.num_frames / info.sample_rate
        except Exception:
            pass
        try:
            import soundfile as sf

            info = sf.info(str(path))
            if info.frames > 0 and info.samplerate > 0:
                return info.frames / info.samplerate
        except Exception:
            pass
        waveform, rate = self._decode(path)
        return waveform.shape[1] / rate

    @staticmethod
    def _probe_wav_duration(path: Path) -> float:
        """Header-only duration probe for RIFF/WAVE files."""
        with open(path, "rb") as f:
            f.read(12)
            rate = None
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                chunk_id, size = struct.unpack("<4sI", header)
                if chunk_id == b"fmt ":
                    fmt = _read_fmt_chunk(f, size, path)
                    rate = fmt[2]
                    bits, channels = fmt[5], fmt[1]
                elif chunk_id == b"data":
                    if (
                        rate is None
                        or rate == 0
                        or channels == 0
                        or bits not in (8, 16, 24, 32)
                    ):
                        break
                    import os

                    avail = max(0, os.fstat(f.fileno()).st_size - f.tell())
                    n = avail if size in (0, 0xFFFFFFFF) else min(size, avail)
                    return n / (rate * channels * (bits // 8))
                else:
                    f.read(size + (size & 1))
        raise ValueError(f"cannot probe duration of {path}")
