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
``np.asarray`` first); the port never imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.common import QuantizableConv

__all__ = ["load_flax_params"]


def _flatten(module: nn.Module, tree: dict, prefix: str, out: Dict[str, np.ndarray]) -> None:
    sub = module.get_submodule(prefix[:-1]) if prefix else module
    if isinstance(sub, (nn.Linear, nn.Conv1d, nn.Conv2d, QuantizableConv)):
        leaves = {"kernel"} | ({"bias"} if sub.bias is not None else set())
        if set(tree) != leaves:
            raise KeyError(f"{prefix[:-1]}: the tree has {sorted(tree)}, the module takes {sorted(leaves)}")
        kernel = np.asarray(tree["kernel"])
        if isinstance(sub, nn.Linear):
            kernel = kernel.T
        elif kernel.ndim == 4:
            kernel = kernel.transpose(3, 2, 0, 1)
        else:
            kernel = kernel.transpose(2, 1, 0)
        out[prefix + "weight"] = kernel
        if sub.bias is not None:
            out[prefix + "bias"] = np.asarray(tree["bias"])
        return
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(module, value, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = np.asarray(value)


def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax parameter tree (``{"params": {...}}`` or its inner dict)
    into ``module`` in place; every parameter of the module must be covered
    and every leaf of the tree used. Returns the module."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat: Dict[str, np.ndarray] = {}
    _flatten(module, tree, "", flat)
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()
    }
    module.load_state_dict(state, strict=True)
    return module
