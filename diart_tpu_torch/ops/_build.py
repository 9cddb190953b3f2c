"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so`` beside the
package (rebuilt when the source or a header of ``csrc/`` is newer) and
loaded with ctypes; pointers and the stream pass as ``c_void_p``.
:func:`build` compiles several sources at once, one ``nvcc`` each, all
started together.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

__all__ = ["KERNELS", "build", "check", "library", "num_sms", "require_cuda", "stream_handle"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("lstm_sweep", "lstm_sweep_bwd", "linear_stats", "attn_stats", "se_res2", "int8_conv",
           "sinc_frontend")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use")


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _target(name)
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return not so.exists() or so.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: Iterable[str] = KERNELS, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (in parallel) and return each build's
    compiler output (``-Xptxas -v`` register/shared-memory report); up-to-date
    libraries are not rebuilt unless ``force``. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def library(name: str, signature: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with its
    C signatures declared by ``signature``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(_target(name)))
            signature(lib)
            getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
            getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """The number of streaming multiprocessors of ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(device) -> torch.device:
    """Resolve an entry point's device; ``cuda`` without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diart_tpu_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return device
