"""Numerics policy of the port: reduced-precision storage switches.

The JAX package's policy (``diart_tpu/precision.py``) holds one switch per
TPU fast path. The port keeps only the ones that change numbers or the
engine's formulation on its paths; its kernels are not switches — a CUDA
tensor always runs its kernel, a CPU tensor its plain version.

* ``bf16_lstm``: bf16 storage for the LSTM's pre-projected gate stream and
  hidden states (gate math and the cell state stay f32).
* ``bf16_frontend``: bf16 storage of the pre-pool SincNet activation
  (instance-norm math stays f32).
* ``fbank_ring``: the engine keeps a mel embedding's raw per-frame log-mel
  features in a rolling ring across hops and computes only the new block's
  frames and the window-edge frames (``parallel/engine.py``).

All default on, as in the JAX package. The two bf16 switches resolve to off
for CPU tensors, the way the JAX package's TPU-only switches resolve to off
off the TPU; ``fbank_ring`` is not TPU-only there and applies on every
device here too.

``Precision.parse`` reads the CLIs' ``--precision`` spec and
``set_default`` installs a policy for every thread (a :func:`use` scope is
thread-local, and the server dispatches its hops on worker threads).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Dict

import torch

__all__ = ["Precision", "active", "enabled", "set_default", "use"]


@dataclasses.dataclass(frozen=True)
class Precision:
    bf16_lstm: bool = True
    bf16_frontend: bool = True
    fbank_ring: bool = True

    @staticmethod
    def from_dict(d: Dict[str, bool]) -> "Precision":
        """A policy from a dict of switches, as the JAX package's
        ``Precision.from_dict``: keys that are not this policy's switches
        (a JAX checkpoint records ``pallas_*`` and others) are left out."""
        known = {f.name for f in dataclasses.fields(Precision)}
        return Precision(**{k: bool(v) for k, v in d.items() if k in known})

    @staticmethod
    def parse(spec: str) -> "Precision":
        """A policy from a ``switch=0|1,...`` spec on top of the defaults
        (the CLIs' ``--precision``). A bare name means on; ``0``,
        ``false``, ``off`` and an empty value mean off. A switch the port
        does not have raises ``ValueError``, the JAX-only ones
        (``pallas_lstm``, ``int8_trunk``, ...) too."""
        overrides: Dict[str, bool] = {}
        known = {f.name for f in dataclasses.fields(Precision)}
        for item in spec.split(","):
            if not item.strip():
                continue
            key, sep, value = item.partition("=")
            key = key.strip()
            if key not in known:
                raise ValueError(f"unknown precision switch {key!r}; known: {sorted(known)}")
            overrides[key] = value.strip().lower() not in ("0", "false", "off", "") if sep else True
        return dataclasses.replace(Precision(), **overrides)

    @staticmethod
    def portable() -> "Precision":
        """Everything off: the f32 direct formulation on every device."""
        return Precision(bf16_lstm=False, bf16_frontend=False, fbank_ring=False)

    def as_dict(self) -> Dict[str, bool]:
        """The declared switches (a checkpoint records them)."""
        return dataclasses.asdict(self)

    def resolved(self, device) -> Dict[str, bool]:
        """The switches as they apply to tensors on ``device`` (the CUDA-only
        ones off elsewhere); a checkpoint records these beside the declared
        ones, so its numerics can be reproduced."""
        with use(self):
            return {f.name: enabled(f.name, device) for f in dataclasses.fields(self)}


_CUDA_ONLY = frozenset(("bf16_lstm", "bf16_frontend"))


_DEFAULT = Precision()
_STATE = threading.local()


def active() -> Precision:
    """The innermost :func:`use` scope's policy, else the default."""
    return getattr(_STATE, "policy", None) or _DEFAULT


def set_default(policy: Precision) -> None:
    """Set the process-wide default policy, which every thread sees outside
    a :func:`use` scope."""
    global _DEFAULT
    _DEFAULT = policy


def enabled(field: str, device) -> bool:
    """Whether ``field`` applies to tensors on ``device``."""
    policy = active()
    if not hasattr(policy, field):
        raise KeyError(f"unknown precision switch {field!r}")
    on_device = field not in _CUDA_ONLY or torch.device(device).type == "cuda"
    return on_device and bool(getattr(policy, field))


@contextmanager
def use(policy: Precision):
    """Scoped policy activation (thread-local)."""
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev
