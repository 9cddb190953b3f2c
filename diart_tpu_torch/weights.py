"""Carry the JAX package's flax parameter trees into the port's modules.

The port's modules name their parameters and submodules as the flax
modules do, so a tree maps onto them by path. Layouts that differ:

* flax ``Dense`` kernel (in, out) -> ``nn.Linear`` weight (out, in), with
  or without a bias;
* flax conv kernel (k, in, out) over NWC -> Conv1d-layout weight
  (out, in, k) over NCW (a depthwise kernel (k, 1, C) -> (C, 1, k));
* flax 2-D conv kernel (kh, kw, in, out) over NHWC -> Conv2d-layout
  weight (out, in, kh, kw) over NCHW;
* everything else (LSTM ``l{i}_w_ih/w_hh/b``, ``InferenceBatchNorm``
  ``scale/bias/mean/var``, SincNet ``low_hz/band_hz/wav_norm_*/norm*_*``)
  copies as it is.

Coverage is strict: every leaf of the tree is used and every parameter of
the module is covered, or the load raises.

The tree is given as nested dicts of numpy arrays (convert jax arrays with
``np.asarray`` first) or as :func:`diart_tpu_torch.flaxio.loads` reads a
flax file (``torch.bfloat16`` leaves included); the port never imports
jax. :func:`flax_params` is the inverse: a module's weights as the JAX
package's tree, which :func:`diart_tpu_torch.flaxio.dumps` writes as
``diart_tpu`` would.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.common import QuantizableConv

__all__ = ["flatten_flax", "flax_params", "load_flax_params"]

_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, QuantizableConv)


def _leaf(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def _flatten(module: nn.Module, tree: dict, prefix: str, out: Dict[str, np.ndarray]) -> None:
    sub = module.get_submodule(prefix[:-1]) if prefix else module
    if isinstance(sub, _LAYERS):
        leaves = {"kernel"} | ({"bias"} if sub.bias is not None else set())
        if set(tree) != leaves:
            raise KeyError(f"{prefix[:-1]}: the tree has {sorted(tree)}, the module takes {sorted(leaves)}")
        kernel = _leaf(tree["kernel"])
        if isinstance(sub, nn.Linear):
            kernel = kernel.T
        elif kernel.ndim == 4:
            kernel = kernel.transpose(3, 2, 0, 1)
        else:
            kernel = kernel.transpose(2, 1, 0)
        out[prefix + "weight"] = kernel
        if sub.bias is not None:
            out[prefix + "bias"] = _leaf(tree["bias"])
        return
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(module, value, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = _leaf(value)


def flatten_flax(module: nn.Module, tree: dict) -> Dict[str, np.ndarray]:
    """A flax tree (``{"params": {...}}`` or its inner dict) laid out as
    ``module``'s state dict: {name: array in the port's layout}. A leaf the
    module's structure does not place raises; coverage is the caller's to
    check (``load_state_dict(strict=True)``)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat: Dict[str, np.ndarray] = {}
    _flatten(module, tree, "", flat)
    return flat


def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax parameter tree (``{"params": {...}}`` or its inner dict)
    into ``module`` in place; every parameter of the module must be covered
    and every leaf of the tree used. Returns the module."""
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flatten_flax(module, tree).items()
    }
    module.load_state_dict(state, strict=True)
    return module


def flax_params(module: nn.Module) -> dict:
    """``module``'s state dict as the JAX package's parameter tree
    (``{"params": {...}}``, f32 numpy leaves in flax's layouts, keys
    sorted as flax orders them): the inverse of :func:`load_flax_params`;
    ``flaxio.dumps`` of it is the bytes ``diart_tpu``'s ``save`` writes
    for the same weights."""
    tree: dict = {}
    for name, value in module.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        arr = _leaf(value)
        if leaf == "weight" and isinstance(module.get_submodule(owner), _LAYERS):
            leaf = "kernel"
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.transpose(2, 1, 0)
        node = tree
        for part in owner.split(".") if owner else ():
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr, dtype=np.float32)

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k] for k in sorted(node)}

    return {"params": ordered(tree)}
