"""Training-state checkpoints (port of ``diart_tpu/train/checkpoint.py``).

A checkpoint holds the whole training state (the module's and the
optimizer's ``state_dict``, the step and, for an embedding trainer, the
class prototypes), so interrupted fine-tuning resumes exactly. Files are
written atomically (a ``.tmp`` file, then ``os.replace``), so a crash never
leaves a torn checkpoint.

:func:`restore_train_state` also reads the JAX package's checkpoints
(``step_<n>.msgpack``: flax msgpack of ``TrainState(params, opt_state,
step)``, read by :mod:`diart_tpu_torch.flaxio`), told apart from the
port's by their bytes (a ``torch.save`` file is a zip). ``params`` maps
onto the module as :func:`diart_tpu_torch.weights.load_flax_params` maps
a model file (an embedding trainer's ``{"model", "prototypes"}`` onto the
module and the prototypes). ``opt_state`` must be ``optax.adamw``'s with a
constant learning rate, the chain ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())``, which flax writes as the map ``{"0":
{"count", "mu", "nu"}, "1": {}, "2": {}}``: ``mu`` / ``nu`` go, in the
port's layouts, to ``torch.optim.AdamW``'s ``exp_avg`` / ``exp_avg_sq``
and ``count`` to each parameter's ``step``. The learning rate and the
decay stay the template optimizer's (the port's AdamW takes optax's
defaults). Any other optimizer state, or a tree that does not cover the
template, raises.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import flaxio
from ..models.base import ZIP_MAGIC
from ..weights import flatten_flax, load_flax_params
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


def _checkpoints(directory: Path) -> dict:
    """{step: path} of the checkpoints in ``directory``: the port's
    ``step_<n>.pt`` and the JAX package's ``step_<n>.msgpack``, the
    former where both hold one step."""
    found = {}
    for suffix in (".msgpack", ".pt"):
        for path in directory.glob(f"step_*{suffix}"):
            try:
                found[int(path.stem[len("step_"):])] = path
            except ValueError:
                continue
    return found


def latest_checkpoint(directory: Union[str, Path]) -> Optional[Path]:
    """The checkpoint to resume from: the one ``latest.json`` names (the
    most recently written: after a rollback the highest step is an abandoned
    branch), else the highest step when the marker is missing or stale.
    A step's ``.pt`` is taken over its ``.msgpack`` (a JAX package's
    directory holds only the latter)."""
    directory = Path(directory)
    found = _checkpoints(directory)
    marker = directory / "latest.json"
    if marker.exists():
        try:
            step = int(json.loads(marker.read_text())["step"])
            if step in found:
                return found[step]
        except (ValueError, KeyError, TypeError):
            pass
    return found[max(found)] if found else None


def _adam_state(opt_state, path) -> tuple:
    """(count, mu, nu) of ``optax.adamw``'s state as flax writes it; any
    other optimizer state raises."""
    ok = (isinstance(opt_state, dict) and set(opt_state) == {"0", "1", "2"}
          and opt_state["1"] == {} and opt_state["2"] == {}
          and isinstance(opt_state["0"], dict) and set(opt_state["0"]) == {"count", "mu", "nu"})
    if not ok:
        shape = {k: sorted(v) if isinstance(v, dict) else type(v).__name__ for k, v in opt_state.items()} \
            if isinstance(opt_state, dict) else type(opt_state).__name__
        raise ValueError(
            f"{path}: the optimizer state is not optax.adamw's with a constant learning rate "
            f"(want {{'0': [count, mu, nu], '1': [], '2': []}}; got {shape})"
        )
    adam = opt_state["0"]
    return int(np.asarray(adam["count"])), adam["mu"], adam["nu"]


def _restore_flax(path: Path, data: bytes, template: TrainState) -> TrainState:
    """A JAX package checkpoint into ``template`` in place (see the module
    docstring)."""
    tree = flaxio.loads(data)
    if not (isinstance(tree, dict) and set(tree) == {"params", "opt_state", "step"}):
        raise ValueError(f"{path}: not a TrainState (want params, opt_state, step)")
    embedding = template.prototypes is not None
    count, mu, nu = _adam_state(tree["opt_state"], path)

    def split(params, what):
        """(the model's tree, the prototypes or None) of a params-shaped tree."""
        if not embedding:
            return params, None
        if not (isinstance(params, dict) and set(params) == {"model", "prototypes"}):
            raise ValueError(f"{path}: {what} is not an embedding trainer's {{model, prototypes}} tree")
        return params["model"], np.asarray(params["prototypes"], np.float32)

    module = template.module
    model_tree, protos = split(tree["params"], "params")
    load_flax_params(module, model_tree)
    names = {id(p): name for name, p in module.named_parameters()}
    moments = {}  # name -> (exp_avg, exp_avg_sq)
    (mu_tree, mu_protos), (nu_tree, nu_protos) = split(mu, "mu"), split(nu, "nu")
    flat_mu, flat_nu = flatten_flax(module, mu_tree), flatten_flax(module, nu_tree)
    if set(flat_mu) != set(names.values()) or set(flat_nu) != set(names.values()):
        raise ValueError(f"{path}: the optimizer's moments do not cover the module's parameters")
    for name in names.values():
        moments[name] = (flat_mu[name], flat_nu[name])
    if embedding:
        if protos.shape != tuple(template.prototypes.shape):
            raise ValueError(f"{path}: prototypes {protos.shape}; the template has "
                             f"{tuple(template.prototypes.shape)}")
        with torch.no_grad():
            template.prototypes.copy_(torch.from_numpy(protos))
        names[id(template.prototypes)] = "prototypes"
        moments["prototypes"] = (mu_protos, np.asarray(nu_protos, np.float32))
    state_dict = template.optimizer.state_dict()
    state = {}
    for group, ids in zip(template.optimizer.param_groups, (g["params"] for g in state_dict["param_groups"])):
        for param, index in zip(group["params"], ids):
            name = names.get(id(param))
            if name is None:
                raise ValueError("the template optimizer holds a parameter that is neither the module's "
                                 "nor the prototypes")
            exp_avg, exp_avg_sq = (torch.from_numpy(np.array(m, np.float32)) for m in moments[name])
            if exp_avg.shape != param.shape or exp_avg_sq.shape != param.shape:
                raise ValueError(f"{path}: the moments of {name} are {tuple(exp_avg.shape)}; "
                                 f"the parameter is {tuple(param.shape)}")
            state[index] = {"step": torch.tensor(float(count)), "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    template.optimizer.load_state_dict(dict(state_dict, state=state))
    return template._replace(step=int(np.asarray(tree["step"])))


def restore_train_state(path: Union[str, Path], template: TrainState) -> TrainState:
    """Load a checkpoint file (or a directory's latest) into ``template``'s
    module, optimizer and prototypes in place; returns the template with
    the checkpoint's step. The port's checkpoints are read with
    ``weights_only=True``; the JAX package's as the module docstring says."""
    path = Path(path)
    if path.is_dir():
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = latest
    data = path.read_bytes()
    if data[:4] != ZIP_MAGIC:
        return _restore_flax(path, data, template)
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
