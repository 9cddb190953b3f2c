"""Fine-tuning of the segmentation model (port of
``diart_tpu/train/segmentation.py``).

A permutation-invariant BCE training step, the standard EEND/PyanNet
objective: speaker identities within a chunk are arbitrary, so the loss is
minimized over output-channel permutations. The state holds the module, its
``torch.optim.AdamW`` (optax's ``adamw`` defaults) and the step count. On
the card the forward goes through the hand-written kernels and the backward
through their plain versions (``diart_tpu_torch.ops``).
"""

from __future__ import annotations

import functools
from itertools import permutations
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["pit_bce_loss", "TrainState", "make_train_state", "train_step"]

# optax.adamw's defaults (torch.optim.AdamW decays by 1e-2 unless told)
ADAMW_DEFAULTS = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@functools.lru_cache(maxsize=None)
def _permutation_onehots(k: int, device: torch.device) -> torch.Tensor:
    """(K!, K, K) one-hot of every permutation of K channels."""
    perms = torch.tensor(list(permutations(range(k))))
    return F.one_hot(perms, k).float().to(device)


def pit_bce_loss(predictions: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Permutation-invariant binary cross-entropy.

    predictions/targets: (batch, frames, speakers) in [0, 1]. For each sample
    the speaker-channel permutation minimizing mean BCE is selected. BCE is
    a sum of per-(prediction channel, target channel) terms, so the
    permutations are scored from the frame-summed pairwise (B, K, K) matrix
    instead of a (K!, B, F, K) tensor: O(K^2) memory, exactly equal.
    Returns a 0-d tensor.
    """
    k = predictions.shape[-1]
    p = torch.clamp(predictions, eps, 1.0 - eps)
    # pair[b, i, j] = sum_f BCE(p[b, f, i], t[b, f, j])
    pair = -(
        torch.einsum("bfi,bfj->bij", torch.log(p), targets)
        + torch.einsum("bfi,bfj->bij", torch.log1p(-p), 1.0 - targets)
    )
    onehot = _permutation_onehots(k, pair.device).to(pair.dtype)  # (P, K, K)
    per_perm = torch.einsum("bij,pij->pb", pair, onehot) / (predictions.shape[1] * k)
    # amin splits the gradient between tied permutations, as jnp.min does
    return torch.amin(per_perm, dim=0).mean()


class TrainState(NamedTuple):
    """The trained module, its optimizer and the steps taken. ``prototypes``
    are the AAM-softmax class prototypes of an embedding trainer (trained
    with the module), None for the segmentation trainer."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    prototypes: Optional[nn.Parameter] = None


def trainable(model) -> nn.Module:
    """The ``nn.Module`` of a model (a ``SegmentationModel`` or an
    ``EmbeddingModel``, or a module itself), with gradients turned on for
    its parameters: ``from_pretrained`` gives frozen modules."""
    module = getattr(model, "module", model)
    if not isinstance(module, nn.Module):
        raise TypeError(f"expected an nn.Module or a model holding one; got {type(module).__name__}")
    return module.requires_grad_(True)


def make_train_state(model, learning_rate: float = 1e-4) -> Tuple[TrainState, torch.optim.Optimizer]:
    """A fresh state over every parameter of ``model`` (the inference batch
    norms' statistics included: optax decays and updates every leaf)."""
    module = trainable(model)
    optimizer = torch.optim.AdamW(module.parameters(), lr=learning_rate, **ADAMW_DEFAULTS)
    return TrainState(module, optimizer, 0), optimizer


def train_step(
    apply_fn: Callable,
    optimizer: torch.optim.Optimizer,
    state: TrainState,
    waveforms: torch.Tensor,
    targets: torch.Tensor,
) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step. ``apply_fn(module, waveforms)`` -> (batch, frames,
    speakers); ``waveforms``: (batch, 1, samples); ``targets``: (batch,
    frames, speakers). Returns the new state and the loss before the step
    (0-d, detached; reading it is the caller's host sync)."""
    optimizer.zero_grad(set_to_none=True)
    loss = pit_bce_loss(apply_fn(state.module, waveforms), targets)
    loss.backward()
    optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()
