"""True f32 on the card, whatever torch's TF32 switches say.

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
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["conv_scope", "true_f32"]

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
