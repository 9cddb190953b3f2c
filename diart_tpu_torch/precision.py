"""Numerics policy of the port: reduced-precision storage switches.

The JAX package's policy (``diart_tpu/precision.py``) holds one switch per
TPU fast path. The port keeps only the two that change numbers on the main
path; its kernels are not switches — a CUDA tensor always runs its kernel,
a CPU tensor its plain version.

* ``bf16_lstm``: bf16 storage for the LSTM's pre-projected gate stream and
  hidden states (gate math and the cell state stay f32).
* ``bf16_frontend``: bf16 storage of the pre-pool SincNet activation
  (instance-norm math stays f32).

Both default on, as in the JAX package, and resolve to off for CPU tensors,
the way its TPU-only switches resolve to off off the TPU.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

import torch

__all__ = ["Precision", "active", "enabled", "use"]


@dataclasses.dataclass(frozen=True)
class Precision:
    bf16_lstm: bool = True
    bf16_frontend: bool = True

    @staticmethod
    def portable() -> "Precision":
        """Everything off: the f32 formulation on every device."""
        return Precision(bf16_lstm=False, bf16_frontend=False)


_DEFAULT = Precision()
_STATE = threading.local()


def active() -> Precision:
    """The innermost :func:`use` scope's policy, else the default."""
    return getattr(_STATE, "policy", None) or _DEFAULT


def enabled(field: str, device) -> bool:
    """Whether ``field`` applies to tensors on ``device``."""
    policy = active()
    if not hasattr(policy, field):
        raise KeyError(f"unknown precision switch {field!r}")
    return torch.device(device).type == "cuda" and bool(getattr(policy, field))


@contextmanager
def use(policy: Precision):
    """Scoped policy activation (thread-local)."""
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev
