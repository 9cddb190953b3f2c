"""Devices and process groups for stream-level data parallelism (port of
``diart_tpu/parallel/mesh.py``).

The engine scales out by cutting its stream batch into equal contiguous
shards, one for each slot of a :class:`StreamsMesh`: process-major, then
this process's local devices in order, the layout JAX's
``NamedSharding(mesh, P("streams"))`` gives the same global axis. Streams
are independent, so the serving step needs no collective; the trainers
all-reduce their gradients over the mesh's process group.

Multi-process runs: :func:`initialize_distributed` calls
``torch.distributed.init_process_group`` from ``DIART_TPU_COORDINATOR``
(``host:port``), ``DIART_TPU_NUM_PROCESSES`` and ``DIART_TPU_PROCESS_ID``,
the JAX package's variables, with ``nccl`` for CUDA devices and ``gloo``
for CPU ones. Launch the same script once per process with those set; each
process drives its own slice of the streams (``StreamsMesh.local_slice``).
With no coordinator everything is one process.

Devices: :func:`provision_devices` gives CUDA devices or raises. It never
falls back to the CPU: CPU shard slots (the counterpart of JAX's virtual
CPU devices) exist only where the caller asks for ``device="cpu"``, as the
tests and the CLIs' ``--cpu`` do. An explicit device list may repeat a
device: ``streams_mesh(devices=["cuda:0", "cuda:0"])`` cuts the streams
into two shards on one card, each with its own state and launches, which
is how the sharded path runs on a one-card machine.

The JAX module's ``_probe_default_backend``, ``effective_platform`` and
``_backend_initialized`` guard against a remote-TPU transport that hangs
``jax.devices()`` forever; CUDA initialization fails instead of hanging,
so the port has no counterpart of them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["StreamsMesh", "initialize_distributed", "provision_devices", "streams_mesh"]


_distributed_ready = False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Join the process group of a multi-process run.

    Arguments default to the ``DIART_TPU_COORDINATOR`` (``host:port``) /
    ``DIART_TPU_NUM_PROCESSES`` / ``DIART_TPU_PROCESS_ID`` environment
    variables; ``backend`` to ``nccl`` for a CUDA ``device`` and ``gloo``
    for a CPU one. A no-op returning False when no coordinator is configured
    (one process); True once the group is up. Idempotent: safe to call from
    every entry point that builds a mesh."""
    global _distributed_ready
    if _distributed_ready or dist.is_initialized():
        _distributed_ready = True
        return True
    coordinator_address = coordinator_address or os.environ.get("DIART_TPU_COORDINATOR")
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = os.environ.get("DIART_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = os.environ.get("DIART_TPU_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs the number of processes and this process's id "
            "(DIART_TPU_NUM_PROCESSES / DIART_TPU_PROCESS_ID)"
        )
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _distributed_ready = True
    return True


def provision_devices(n_devices: int, device="cuda") -> Tuple[torch.device, ...]:
    """``n_devices`` shard slots of kind ``device``: this process's first
    ``n_devices`` CUDA devices, or raise when there are fewer (never a CPU
    downgrade); with ``device="cpu"``, ``n_devices`` CPU slots."""
    kind = torch.device(device).type
    if n_devices < 1:
        raise ValueError(f"need at least one device; got {n_devices}")
    if kind == "cpu":
        return (torch.device("cpu"),) * n_devices
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(
            f"need {n_devices} CUDA devices, this process sees {have}; pass device='cpu' "
            f"for CPU shard slots, or an explicit device list (a device may repeat)"
        )
    return tuple(torch.device("cuda", i) for i in range(n_devices))


@dataclasses.dataclass(frozen=True)
class StreamsMesh:
    """The ``streams`` axis of a run: this process's shard slots
    (``devices``, in order; a device may repeat), its ``rank`` in a group of
    ``world_size`` processes and the group (None in one process). Every
    process holds the same number of slots; the global axis has
    ``size = world_size * len(devices)`` shards."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.world_size * len(self.devices)

    def shard_size(self, batch: int) -> int:
        """Streams a shard holds of a global batch of ``batch``."""
        if batch % self.size:
            raise ValueError(f"the stream batch ({batch}) must be divisible by the mesh size ({self.size})")
        return batch // self.size

    def local_slice(self, batch: int) -> slice:
        """This process's streams of a global batch of ``batch``."""
        per = self.shard_size(batch) * len(self.devices)
        return slice(self.rank * per, (self.rank + 1) * per)


def streams_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> StreamsMesh:
    """The ``streams`` mesh of this process.

    ``devices``: this process's shard slots, as given (a device may repeat).
    Otherwise :func:`provision_devices` of ``n_devices / world_size`` slots
    of kind ``device`` (``n_devices`` counts the whole group's slots, as in
    the JAX module; None: every visible CUDA device, or one CPU slot).
    Calls :func:`initialize_distributed` first (``backend`` as there), so a
    coordinator-configured launch gets its group with no extra code."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        device = devices[0]
    initialize_distributed(backend=backend, device=device)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        if n_devices is None:
            kind = torch.device(device).type
            local = torch.cuda.device_count() if kind == "cuda" and torch.cuda.is_available() else 1
        else:
            if n_devices % world:
                raise ValueError(f"{n_devices} devices do not divide over {world} processes")
            local = n_devices // world
        devices = provision_devices(local, device)
    elif n_devices is not None and n_devices != world * len(devices):
        raise ValueError(f"n_devices={n_devices} but the group holds {world} x {len(devices)} slots")
    return StreamsMesh(devices, rank, world, group)
