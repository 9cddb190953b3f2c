"""Speaker-embedding training with additive-angular-margin softmax (port of
``diart_tpu/train/embedding.py``).

The standard discriminative objective of the embedding models' recipes
(ArcFace/AAM-softmax; x-vector, ECAPA and wespeaker ResNet are all trained
this way): embeddings and per-class prototypes are L2-normalized, the target
class's angle gets an additive margin, and the scaled cosine logits feed a
cross-entropy. The prototypes are a parameter trained with the model and
discarded at serving time.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .segmentation import ADAMW_DEFAULTS, TrainState, _step, trainable

__all__ = ["aam_softmax_loss", "make_embedding_train_state", "embedding_train_step"]


def aam_softmax_loss(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    prototypes: torch.Tensor,
    margin: float = 0.2,
    scale: float = 30.0,
) -> torch.Tensor:
    """Additive angular margin softmax (ArcFace).

    embeddings: (batch, dim); labels: (batch,) int class ids; prototypes:
    (num_classes, dim); margin: the angle (radians) added to the target
    class; scale: the logit scale after the margin. Returns a 0-d tensor.
    """
    emb = embeddings / torch.clamp(torch.linalg.norm(embeddings, dim=-1, keepdim=True), min=1e-12)
    protos = prototypes / torch.clamp(torch.linalg.norm(prototypes, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(emb @ protos.t(), -1.0, 1.0)  # (B, C)
    # cos(theta + m) by the angle-sum identity (no arccos: its gradient is
    # singular at |cos| = 1, which NaNs training once embeddings align)
    sin = torch.sqrt(torch.clamp(1.0 - cos**2, 1e-12, 1.0))
    phi = cos * math.cos(margin) - sin * math.sin(margin)
    # past pi - m the margined angle wraps: the linear penalty instead
    # (ArcFace's hard-example branch)
    phi = torch.where(cos > math.cos(math.pi - margin), phi, cos - margin * math.sin(margin))
    onehot = F.one_hot(labels.long(), prototypes.shape[0]).to(cos.dtype)
    logits = scale * (onehot * phi + (1.0 - onehot) * cos)
    return F.cross_entropy(logits, labels.long())


def make_embedding_train_state(
    model,
    num_classes: int,
    embedding_dim: int,
    learning_rate: float = 1e-4,
    seed: int = 0,
) -> Tuple[TrainState, torch.optim.Optimizer]:
    """A state over the model's parameters and ``num_classes`` prototypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` and scaled by
    ``1 / sqrt(embedding_dim)``, on the model's device."""
    module = trainable(model)
    device = next(module.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    prototypes = nn.Parameter(
        (torch.randn(num_classes, embedding_dim, generator=gen) / math.sqrt(embedding_dim)).to(device)
    )
    optimizer = torch.optim.AdamW(
        [*module.parameters(), prototypes], lr=learning_rate, **ADAMW_DEFAULTS
    )
    return TrainState(module, optimizer, 0, prototypes), optimizer


def embedding_train_step(
    embed_fn: Callable,
    optimizer: torch.optim.Optimizer,
    state: TrainState,
    waveforms: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 0.2,
    scale: float = 30.0,
    dp=None,
) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step. ``embed_fn(module, waveforms (B, 1, S))`` -> (B, dim),
    e.g. ``lambda m, w: m(w)`` (uniform pooling weights); ``labels``: (B,)
    speaker ids. Returns the new state and the loss before the step (0-d,
    detached). With ``dp`` (a StreamsMesh or a process group) the batch is
    the global one: each rank takes its slice and the gradients and the
    loss are averaged over the group (``train/segmentation.py``)."""
    return _step(optimizer, state, lambda w, y: aam_softmax_loss(
        embed_fn(state.module, w), y, state.prototypes, margin=margin, scale=scale
    ), (waveforms, labels), dp)
