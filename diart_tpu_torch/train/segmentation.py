"""Fine-tuning of the segmentation model (port of
``diart_tpu/train/segmentation.py``).

A permutation-invariant BCE training step, the standard EEND/PyanNet
objective: speaker identities within a chunk are arbitrary, so the loss is
minimized over output-channel permutations. The state holds the module, its
``torch.optim.AdamW`` (optax's ``adamw`` defaults) and the step count. On
the card the forward goes through the hand-written kernels and the backward
through their plain versions (``diart_tpu_torch.ops``).

Data parallelism (``dp``: a :class:`~diart_tpu_torch.parallel.StreamsMesh`
of one device a process, or a ``torch.distributed`` process group), the
counterpart of the JAX trainers jitted with the batch sharded over a ``dp``
axis: every rank is handed the global batch and takes its contiguous slice
(rank-major), and the gradients and the reported loss are all-reduced and
divided by the world size before the update, so every rank takes the same
step. The models' batch norms hold running statistics as parameters, so a
slice's forward is the global batch's rows: the step equals one process's
up to the order of the sums.
"""

from __future__ import annotations

import functools
from itertools import permutations
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
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


class DataParallel(NamedTuple):
    """A data-parallel step's group, this process's rank and the world size."""

    group: Optional[object]
    rank: int
    world_size: int

    @staticmethod
    def of(dp) -> "DataParallel":
        """``dp``: a StreamsMesh (one device a process) or a process group."""
        if hasattr(dp, "devices"):
            if len(dp.devices) != 1:
                raise ValueError(
                    f"data-parallel training takes one device a process; the mesh gives this "
                    f"process {len(dp.devices)}"
                )
            return DataParallel(dp.group, dp.rank, dp.world_size)
        return DataParallel(dp, dist.get_rank(dp), dist.get_world_size(dp))

    def local(self, *batch: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """This rank's contiguous slice of each global batch tensor."""
        n = batch[0].shape[0]
        if n % self.world_size:
            raise ValueError(f"the batch ({n}) must be divisible by the world size ({self.world_size})")
        per = n // self.world_size
        return tuple(t[self.rank * per:(self.rank + 1) * per] for t in batch)

    def average(self, tensors) -> None:
        """All-reduce ``tensors`` (f32, on one device) in place to their mean
        over the group, as one flat buffer: one collective a step."""
        if self.world_size == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world_size)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _step(optimizer, state, loss_of: Callable, batch: tuple, dp) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on ``loss_of(*batch)``. With ``dp`` (see the module
    docstring) ``batch`` is the global one: this rank trains on its slice,
    and the gradients and the loss are averaged over the group before the
    update."""
    dp = None if dp is None else DataParallel.of(dp)
    if dp is not None:
        batch = dp.local(*batch)
    optimizer.zero_grad(set_to_none=True)
    loss = loss_of(*batch)
    loss.backward()
    loss = loss.detach()
    if dp is not None:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        dp.average([p.grad for p in params if p.grad is not None] + [loss])
    optimizer.step()
    return state._replace(step=state.step + 1), loss


def train_step(
    apply_fn: Callable,
    optimizer: torch.optim.Optimizer,
    state: TrainState,
    waveforms: torch.Tensor,
    targets: torch.Tensor,
    dp=None,
) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step. ``apply_fn(module, waveforms)`` -> (batch, frames,
    speakers); ``waveforms``: (batch, 1, samples); ``targets``: (batch,
    frames, speakers). Returns the new state and the loss before the step
    (0-d, detached; reading it is the caller's host sync). With ``dp`` (see
    the module docstring) the batch is the global one and the step data
    parallel."""
    return _step(optimizer, state, lambda w, t: pit_bce_loss(apply_fn(state.module, w), t),
                 (waveforms, targets), dp)
