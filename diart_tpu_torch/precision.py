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
* ``int8_trunk``: dynamic int8 quantization of the embedding trunks'
  ``QuantizableConv`` convolutions (``ops/quant.py``): per-sample activation
  scales, per-output-channel weight scales, s8 x s8 -> s32 products.
  Quality-affecting, so off by default, as in the JAX package.
* ``stack_frontend``: when the segmentation and the embedding carry
  distinct SincNet filterbanks of one geometry, the engine folds each
  model's waveform-norm affine into its filters and runs one 160-channel
  sinc convolution for both (``parallel/engine.py``). Off by default, as
  in the JAX package.

The first three default on, as in the JAX package. The two bf16 switches
resolve to off for CPU tensors, the way the JAX package's TPU-only
switches resolve to off off the TPU; ``fbank_ring``, ``int8_trunk`` and
``stack_frontend`` are not TPU-only there and apply on every device here
too.

:func:`enabled` resolves a switch as the JAX package does, in order: the
device gate (the bf16 switches are off for CPU tensors whatever else
says), then the switch's ``DIART_TPU_*`` environment variable where it is
set (``DIART_TPU_BF16_LSTM``, ``DIART_TPU_BF16_FRONTEND``,
``DIART_TPU_FBANK_RING``, ``DIART_TPU_INT8_TRUNK``,
``DIART_TPU_STACK_FRONTEND``; ``0``, ``false``, ``off`` and the empty
string mean off, anything else on), then the active policy.
``use(policy, force=True)`` ignores the environment inside its scope. The
JAX package's other variables (``DIART_TPU_PALLAS_*``,
``DIART_TPU_LSTM_BLOCK``, ``DIART_TPU_LSTM_BLOCK_K``,
``DIART_TPU_FAST_FBANK``, ``DIART_TPU_PHASED_RING``) name switches the
port does not have and are not read: a kernel is not a switch here, so no
variable routes a CUDA tensor to a plain version.

``Precision.parse`` reads the CLIs' ``--precision`` spec and
``set_default`` installs a policy for every thread (a :func:`use` scope is
thread-local, and the server dispatches its hops on worker threads).
"""

from __future__ import annotations

import dataclasses
import os
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
    int8_trunk: bool = False
    stack_frontend: bool = False

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
        (``pallas_lstm``, ``lstm_block``, ...) too."""
        overrides: Dict[str, bool] = {}
        known = {f.name for f in dataclasses.fields(Precision)}
        for item in spec.split(","):
            if not item.strip():
                continue
            key, sep, value = item.partition("=")
            key = key.strip()
            if key not in known:
                raise ValueError(f"unknown precision switch {key!r}; known: {sorted(known)}")
            overrides[key] = value.strip().lower() not in _OFF if sep else True
        return dataclasses.replace(Precision(), **overrides)

    @staticmethod
    def portable() -> "Precision":
        """Everything off: the f32 direct formulation on every device."""
        return Precision(bf16_lstm=False, bf16_frontend=False, fbank_ring=False)

    def as_dict(self) -> Dict[str, bool]:
        """The declared switches (a checkpoint records them)."""
        return dataclasses.asdict(self)

    def resolved(self, device) -> Dict[str, bool]:
        """The switches as they apply to tensors on ``device`` (the device
        gate and the environment applied); a checkpoint records these beside
        the declared ones, so its numerics can be reproduced."""
        return {name: _resolve(self, name, device) for name in _ENV_VARS}


_ENV_VARS = {
    "bf16_lstm": "DIART_TPU_BF16_LSTM",
    "bf16_frontend": "DIART_TPU_BF16_FRONTEND",
    "fbank_ring": "DIART_TPU_FBANK_RING",
    "int8_trunk": "DIART_TPU_INT8_TRUNK",
    "stack_frontend": "DIART_TPU_STACK_FRONTEND",
}
_CUDA_ONLY = frozenset(("bf16_lstm", "bf16_frontend"))
_OFF = ("0", "false", "off", "")  # the spellings of off, in a spec and in a variable


_DEFAULT = Precision()
_STATE = threading.local()


def _resolve(policy: Precision, field: str, device) -> bool:
    if field in _CUDA_ONLY and torch.device(device).type != "cuda":
        return False
    if not getattr(_STATE, "force", False):
        env = os.environ.get(_ENV_VARS[field])
        if env is not None:
            return env.strip().lower() not in _OFF
    return bool(getattr(policy, field))


def active() -> Precision:
    """The innermost :func:`use` scope's policy, else the default."""
    return getattr(_STATE, "policy", None) or _DEFAULT


def set_default(policy: Precision) -> None:
    """Set the process-wide default policy, which every thread sees outside
    a :func:`use` scope."""
    global _DEFAULT
    _DEFAULT = policy


def enabled(field: str, device) -> bool:
    """Whether ``field`` applies to tensors on ``device`` (see the module
    docstring for the order of resolution)."""
    if field not in _ENV_VARS:
        raise KeyError(f"unknown precision switch {field!r}; known: {sorted(_ENV_VARS)}")
    return _resolve(active(), field, device)


@contextmanager
def use(policy: Precision, force: bool = False):
    """Scoped policy activation (thread-local). ``force=True`` also ignores
    the ``DIART_TPU_*`` variables inside the scope; the previous policy and
    force are restored on exit."""
    prev_policy = getattr(_STATE, "policy", None)
    prev_force = getattr(_STATE, "force", False)
    _STATE.policy = policy
    _STATE.force = force
    try:
        yield policy
    finally:
        _STATE.policy = prev_policy
        _STATE.force = prev_force
