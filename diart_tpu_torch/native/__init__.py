"""Native host components, loaded with ctypes: the RTTM assembler
(``rttm.cpp``) and the WAV decoder (``wavio.cpp``, copies of the JAX
package's).

The RTTM assembler is the serving path's post-fetch half: packed bits or f32
scores of a hop -> one RTTM text per stream, string-identical to the numpy
routes of ``ops/binarize.py`` (its plain versions). The WAV decoder is
:class:`diart_tpu_torch.audio.AudioLoader`'s mono route. Each shared library
is compiled at first use with the system C++ compiler into ``build/native/``
beside the package, and rebuilt when its source is newer. There is no quiet
fallback: where no compiler can build a library, its loader raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "build",
    "build_wavio",
    "native_available",
    "rttm_available",
    "rttm_from_bits",
    "rttm_from_scores",
    "wav_decode_mono",
    "wav_probe",
]

_SRC = Path(__file__).resolve().parent / "rttm.cpp"
_WAV_SRC = _SRC.parent / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB_PATH = BUILD_DIR / "librttm.so"
_WAV_LIB_PATH = BUILD_DIR / "libwavio.so"
COMPILERS = ("c++", "g++", "clang++")
_lock = threading.Lock()
_lib = None
_wav_lib = None


def _compile(src: Path, lib_path: Path, what: str, force: bool) -> Path:
    """Compile ``src`` into ``lib_path`` (when stale, or always with
    ``force``). Raises if no compiler builds it."""
    fresh = lib_path.exists() and lib_path.stat().st_mtime >= src.stat().st_mtime
    if fresh and not force:
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f".{lib_path.stem}.{os.getpid()}.so"
    errors = []
    for compiler in COMPILERS:
        try:
            subprocess.run(
                [compiler, "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                check=True, capture_output=True, text=True, timeout=120,
            )
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{compiler}: {getattr(exc, 'stderr', None) or exc}")
            continue
        os.replace(tmp, lib_path)
        return lib_path
    raise RuntimeError(
        f"cannot build the native {what} (diart_tpu_torch/native/{src.name}): " + "; ".join(errors)
    )


def build(force: bool = False) -> Path:
    """Compile ``rttm.cpp`` into ``build/native/librttm.so`` (when stale, or
    always with ``force``). Raises if no compiler builds it."""
    return _compile(_SRC, _LIB_PATH, "RTTM assembler", force)


def build_wavio(force: bool = False) -> Path:
    """Compile ``wavio.cpp`` into ``build/native/libwavio.so`` (when stale,
    or always with ``force``). Raises if no compiler builds it."""
    return _compile(_WAV_SRC, _WAV_LIB_PATH, "WAV decoder", force)


def _declare_rttm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of an RTTM assembler library (``rttm.cpp``'s
    interface) on ``lib`` and return it."""
    c_charpp = ctypes.POINTER(ctypes.c_char_p)
    lib.rttm_from_bits.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte),  # bits
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),  # window_starts
        ctypes.c_double,                  # resolution
        c_charpp,                         # uris
        ctypes.POINTER(ctypes.c_ubyte),   # emit
        ctypes.POINTER(ctypes.c_void_p),  # out
        ctypes.POINTER(ctypes.c_long),    # out_len
    ]
    lib.rttm_from_bits.restype = ctypes.c_int
    lib.rttm_from_scores.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_double,
        ctypes.c_float,
        c_charpp,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.rttm_from_scores.restype = ctypes.c_int
    lib.rttm_free.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_long]
    lib.rttm_free.restype = None
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare_rttm(ctypes.CDLL(str(build())))
        return _lib


def native_available() -> bool:
    """Whether the RTTM assembler builds and loads (False where no compiler
    builds it; :func:`rttm_available` raises there instead)."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def rttm_available() -> bool:
    """Build and load the library now (True), or raise."""
    return _load() is not None


def _rttm_common(b, window_starts, uris, emit):
    starts = np.ascontiguousarray(window_starts, np.float64)
    if starts.shape != (b,):
        # an explicit check (not assert): these guard raw-memory reads in C
        raise ValueError(f"window_starts shape {starts.shape} != ({b},)")
    uri_bytes = [(u.encode() if isinstance(u, str) else u) if u else None for u in uris]
    uri_arr = (ctypes.c_char_p * b)(*uri_bytes)
    if emit is None:
        emit_arr = np.ones(b, np.uint8)
    else:
        emit_arr = np.ascontiguousarray(np.asarray(emit, bool)).view(np.uint8)
        if emit_arr.shape != (b,):
            raise ValueError(f"emit shape {emit_arr.shape} != ({b},)")
    out = (ctypes.c_void_p * b)()
    out_len = (ctypes.c_long * b)()
    return starts, uri_bytes, uri_arr, emit_arr, out, out_len


def _rttm_collect(lib, rc, b, emit_arr, out, out_len) -> List[Optional[str]]:
    try:
        if rc != 0:
            raise MemoryError("the native RTTM assembler could not allocate its output")
        return [
            (ctypes.string_at(out[i], out_len[i]).decode() if out[i] else "")
            if emit_arr[i] else None
            for i in range(b)
        ]
    finally:
        lib.rttm_free(out, b)


def rttm_from_bits(
    bits: np.ndarray, frames: int, speakers: int, window_starts, resolution: float, uris,
    emit=None,
) -> List[Optional[str]]:
    """Native ``ops.binarize.batch_bits_rttm``: (B, stride) packed uint8
    activity -> per-stream RTTM text (None where ``emit`` is False)."""
    lib = _load()
    bits = np.ascontiguousarray(bits, np.uint8)
    b, stride = bits.shape
    if stride < (frames * speakers + 7) // 8:
        raise ValueError(f"packed stride {stride} too small for {frames}x{speakers} bits")
    starts, _keep, uri_arr, emit_arr, out, out_len = _rttm_common(b, window_starts, uris, emit)
    rc = lib.rttm_from_bits(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        b, frames, speakers, stride,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(resolution), uri_arr,
        emit_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out, out_len,
    )
    return _rttm_collect(lib, rc, b, emit_arr, out, out_len)


def rttm_from_scores(
    scores: np.ndarray, window_starts, resolution: float, threshold: float, uris, emit=None,
) -> List[Optional[str]]:
    """Native ``ops.binarize.batch_binarize_rttm``: (B, frames, speakers)
    float32 scores -> per-stream RTTM text (None where ``emit`` is False)."""
    lib = _load()
    scores = np.ascontiguousarray(scores, np.float32)
    b, frames, speakers = scores.shape
    starts, _keep, uri_arr, emit_arr, out, out_len = _rttm_common(b, window_starts, uris, emit)
    rc = lib.rttm_from_scores(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, frames, speakers,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(resolution), np.float32(threshold), uri_arr,
        emit_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out, out_len,
    )
    return _rttm_collect(lib, rc, b, emit_arr, out, out_len)


# --------------------------------------------------------------------- #
# WAV decoder (wavio.cpp)
# --------------------------------------------------------------------- #
def _load_wavio() -> ctypes.CDLL:
    global _wav_lib
    with _lock:
        if _wav_lib is not None:
            return _wav_lib
        lib = ctypes.CDLL(str(build_wavio()))
        lib.wav_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.wav_probe.restype = ctypes.c_int
        lib.wav_decode_mono_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        lib.wav_decode_mono_f32.restype = ctypes.c_long
        _wav_lib = lib
        return _wav_lib


def wav_probe(path) -> Optional[Tuple[int, int, int]]:
    """(sample_rate, num_frames, channels), or None where the decoder
    declines the file (not a WAV it decodes). Raises if the library cannot
    be built."""
    lib = _load_wavio()
    rate, frames, channels = ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    if lib.wav_probe(str(path).encode(), ctypes.byref(rate), ctypes.byref(frames),
                     ctypes.byref(channels)) != 0:
        return None
    return rate.value, frames.value, channels.value


def wav_decode_mono(path) -> Optional[Tuple[np.ndarray, int]]:
    """((1, samples) float32 mono mix, sample_rate), or None where the
    decoder declines the file; :class:`diart_tpu_torch.audio.AudioLoader`
    then decodes it with numpy. Raises if the library cannot be built."""
    probe = wav_probe(path)
    if probe is None:
        return None
    rate, frames, _ = probe
    out = np.empty(frames, dtype=np.float32)
    written = _load_wavio().wav_decode_mono_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames
    )
    if written < 0:
        return None
    return out[:written][None, :], rate
