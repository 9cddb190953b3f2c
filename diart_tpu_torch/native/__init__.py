"""The native RTTM assembler (``rttm.cpp``), loaded with ctypes.

The serving path's post-fetch half: packed bits or f32 scores of a hop ->
one RTTM text per stream, string-identical to the numpy routes of
``ops/binarize.py`` (its plain versions). The shared library is compiled at
first use with the system C++ compiler into ``build/native/`` beside the
package, and rebuilt when the source is newer. There is no quiet fallback:
where no compiler can build it, the loader raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["build", "rttm_available", "rttm_from_bits", "rttm_from_scores"]

_SRC = Path(__file__).resolve().parent / "rttm.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB_PATH = BUILD_DIR / "librttm.so"
COMPILERS = ("c++", "g++", "clang++")
_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> Path:
    """Compile ``rttm.cpp`` into ``build/native/librttm.so`` (when stale, or
    always with ``force``). Raises if no compiler builds it."""
    fresh = _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime
    if fresh and not force:
        return _LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".librttm.{os.getpid()}.so"
    errors = []
    for compiler in COMPILERS:
        try:
            subprocess.run(
                [compiler, "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, text=True, timeout=120,
            )
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{compiler}: {getattr(exc, 'stderr', None) or exc}")
            continue
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    raise RuntimeError(
        "cannot build the native RTTM assembler (diart_tpu_torch/native/rttm.cpp): "
        + "; ".join(errors)
    )


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
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
        _lib = lib
        return _lib


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
