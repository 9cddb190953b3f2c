"""True f32 on the card, whatever torch's TF32 switches say; and the TF32
split of the kernels' f32 routes.

``torch.backends.cudnn.allow_tf32`` is True by default, so a float32
convolution on CUDA runs in TF32 (about three decimal digits) unless the
caller turns it off; ``torch.backends.cuda.matmul.allow_tf32`` governs
float32 matrix products the same way. The JAX package's f32 convolutions
and products are exact f32 off the TPU, where the port is held to them, so
the port runs its f32 convolutions (the sinc filterbank, SincNet's k=5
convolutions, ``QuantizableConv`` in f32, the straight-through backward of
the int8 convolution) and the fbank's and resampler's products under
:func:`true_f32`.

The switches are process-global. The scope is counted: the first scope to
open saves the caller's flags and clears both, the last one to close puts
them back (also when it closes on an exception), so scopes nest and may
open on several threads at once. While one is open, every thread's f32
convolutions run without TF32. In the port one thread queues the card's
work at a time: the server's single dispatch thread (``runtime/server.py``)
and the cohort scheduler's thread (``parallel/cohort.py``) run every step;
their harvest threads fetch and assemble text and run no convolution.

The hand-written kernels' f32 routes run on the TF32 tensor cores at f32
accuracy (3xTF32): each operand ``v`` is split into ``hi``, ``v`` rounded
to TF32, and ``lo``, ``v - hi`` rounded the same way, and a product
accumulates ``lo.hi + hi.lo + hi.hi`` in f32. :func:`split_tf32` makes the
split of the weights they read prepared; the kernels split activations
the same way on the card (``csrc/hopper.cuh`` ``tf32_split``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["conv_scope", "split_tf32", "true_f32"]

_LOCK = threading.Lock()
_open = 0
_saved = None


@contextlib.contextmanager
def true_f32(device):
    """Run f32 convolutions and matrix products without TF32 on CUDA;
    nothing happens for another device."""
    global _open, _saved
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _LOCK:
        if _open == 0:
            _saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _open += 1
    try:
        yield
    finally:
        with _LOCK:
            _open -= 1
            if _open == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _saved
                _saved = None


def conv_scope(device, dtype):
    """:func:`true_f32` for a convolution computed in ``dtype`` where that
    is float32; a bf16 convolution has no TF32 to turn off and gets no
    scope."""
    return true_f32(device) if dtype == torch.float32 else contextlib.nullcontext()


def split_tf32(v: torch.Tensor):
    """``(hi, lo)`` of f32 ``v`` as the kernels split it: ``hi`` is ``v``
    rounded to TF32 (10 mantissa bits, to nearest, ties away from zero: PTX
    ``cvt.rna.tf32.f32``, emulated with integer bit operations) and ``lo``
    is ``v - hi`` rounded the same way; both f32 with the low 13 bits zero."""

    def rna(u: torch.Tensor) -> torch.Tensor:
        bits = u.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    v = v.float()
    hi = rna(v)
    return hi, rna(v - hi)
