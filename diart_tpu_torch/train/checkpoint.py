"""Training-state checkpoints (port of ``diart_tpu/train/checkpoint.py``).

A checkpoint holds the whole training state (the module's and the
optimizer's ``state_dict``, the step and, for an embedding trainer, the
class prototypes), so interrupted fine-tuning resumes exactly. Files are
written atomically (a ``.tmp`` file, then ``os.replace``), so a crash never
leaves a torn checkpoint. The JAX package's flax ``.msgpack`` checkpoints
are not read.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from .segmentation import TrainState

__all__ = ["save_train_state", "restore_train_state", "latest_checkpoint"]


def save_train_state(directory: Union[str, Path], state: TrainState, keep: int = 3) -> Path:
    """Write ``<dir>/step_<n>.pt`` atomically and mark it in ``latest.json``;
    prune to the ``keep`` highest steps, never the file just written. In a
    process group only rank 0 writes (data-parallel ranks hold the same
    state); every rank gets the path."""
    directory = Path(directory)
    step = int(state.step)
    path = directory / f"step_{step:08d}.pt"
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    directory.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    payload = {
        "module": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": step,
        "prototypes": None if state.prototypes is None else state.prototypes.detach(),
    }
    torch.save(payload, tmp)
    os.replace(tmp, path)
    (directory / "latest.json").write_text(json.dumps({"step": step}))
    for old in sorted(directory.glob("step_*.pt"))[:-keep]:
        if old != path:  # never prune the checkpoint just written
            old.unlink()
    return path


def latest_checkpoint(directory: Union[str, Path]) -> Optional[Path]:
    """The checkpoint to resume from: the one ``latest.json`` names (the
    most recently written: after a rollback the highest step is an abandoned
    branch), else the highest step when the marker is missing or stale."""
    directory = Path(directory)
    marker = directory / "latest.json"
    if marker.exists():
        try:
            named = directory / f"step_{int(json.loads(marker.read_text())['step']):08d}.pt"
            if named.exists():
                return named
        except (ValueError, KeyError, TypeError):
            pass
    checkpoints = sorted(directory.glob("step_*.pt"))
    return checkpoints[-1] if checkpoints else None


def restore_train_state(path: Union[str, Path], template: TrainState) -> TrainState:
    """Load a checkpoint file (or a directory's latest) into ``template``'s
    module, optimizer and prototypes in place (``weights_only=True``);
    returns the template with the checkpoint's step."""
    path = Path(path)
    if path.is_dir():
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = latest
    device = next(template.module.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if (payload["prototypes"] is None) != (template.prototypes is None):
        raise ValueError(f"{path} and the template disagree on class prototypes")
    template.module.load_state_dict(payload["module"])
    template.optimizer.load_state_dict(payload["optimizer"])
    if template.prototypes is not None:
        with torch.no_grad():
            template.prototypes.copy_(payload["prototypes"])
    return template._replace(step=int(payload["step"]))
