"""Core tensor math of the step (port of ``diart_tpu/ops/functional.py``)."""

from __future__ import annotations

from typing import Union

import torch

__all__ = [
    "cosine_cdist",
    "min_max_normalize",
    "normalize_embeddings",
    "overlapped_speech_penalty",
    "reflect_index",
]


def overlapped_speech_penalty(
    segmentation: torch.Tensor, gamma: Union[float, torch.Tensor] = 3.0,
    beta: Union[float, torch.Tensor] = 10.0,
) -> torch.Tensor:
    """``seg**gamma * softmax(beta * seg, -1)**gamma``, clamped to >= 1e-8.
    segmentation: (..., frames, speakers)."""
    probs = torch.softmax(beta * segmentation, dim=-1)
    weights = torch.pow(segmentation, gamma) * torch.pow(probs, gamma)
    return torch.clamp(weights, min=1e-8)


def normalize_embeddings(
    embeddings: torch.Tensor, norm: Union[float, torch.Tensor] = 1.0
) -> torch.Tensor:
    """Scale embeddings (..., speakers, feat) to L2 norm ``norm``. A 2-D
    input gains a leading batch axis, as in the reference; a zero vector
    becomes NaN (0/0), which the clustering treats as inactive."""
    if embeddings.dim() == 2:
        embeddings = embeddings[None]
    emb_norm = torch.linalg.vector_norm(embeddings, ord=2, dim=-1, keepdim=True)
    return norm * embeddings / emb_norm


def cosine_cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine distances ``1 - cos(x_i, y_j)``: (n, d), (m, d) ->
    (n, m). Computed in full f32 (no TF32)."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return 1.0 - (xn[:, None, :] * yn[None, :, :]).sum(-1)


def min_max_normalize(weights: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Min-max normalize along ``dim``; NaN/inf (flat inputs) become 1e-8."""
    min_v = weights.amin(dim=dim, keepdim=True)
    max_v = weights.amax(dim=dim, keepdim=True)
    out = (weights - min_v) / (max_v - min_v)
    return torch.nan_to_num(out, nan=1e-8, posinf=1e-8, neginf=1e-8)


def reflect_index(time: int, start: int, stop: int, device=None) -> torch.Tensor:
    """Frame indices ``start .. stop - 1`` reflected into ``[0, time)``
    without repeating the edge frame (``t < 0 -> -t``,
    ``t >= time -> 2 (time - 1) - t``), as speechbrain's reflect padding."""
    idx = torch.arange(start, stop, device=device).abs()
    return torch.where(idx >= time, 2 * (time - 1) - idx, idx)
