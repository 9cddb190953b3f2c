"""Powerset <-> multilabel segmentation (port of
``diart_tpu/models/powerset.py``).

A powerset model (``pyannote/segmentation-3.0`` style) classifies each
frame into one of the speaker subsets of at most ``max_simultaneous``
speakers; the decode turns the class scores back into per-speaker
activations. Class order is pyannote's ``Powerset``: subsets by increasing
size, lexicographic within a size — K=3, max 2: [{}, {0}, {1}, {2},
{0,1}, {0,2}, {1,2}].
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

__all__ = ["num_powerset_classes", "powerset_mapping", "to_multilabel"]


def powerset_mapping(num_speakers: int, max_simultaneous: int) -> np.ndarray:
    """(num_classes, num_speakers) binary matrix: class -> speaker set."""
    rows = []
    for size in range(max_simultaneous + 1):
        for subset in combinations(range(num_speakers), size):
            row = np.zeros(num_speakers, dtype=np.float32)
            row[list(subset)] = 1.0
            rows.append(row)
    return np.stack(rows)


def num_powerset_classes(num_speakers: int, max_simultaneous: int) -> int:
    return powerset_mapping(num_speakers, max_simultaneous).shape[0]


def to_multilabel(scores: torch.Tensor, mapping, soft: bool = False) -> torch.Tensor:
    """Powerset class scores (..., frames, classes) -> per-speaker
    activations (..., frames, speakers) in [0, 1].

    Hard (the default, pyannote's ``Powerset.to_multilabel``): one-hot of
    the argmax times ``mapping``. Soft: softmax probabilities times
    ``mapping`` (the scores may be log-probabilities or logits)."""
    mapping = torch.as_tensor(mapping, dtype=torch.float32, device=scores.device)
    if soft:
        return torch.matmul(torch.softmax(scores.float(), dim=-1), mapping)
    best = scores.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(best, mapping.shape[0]).to(mapping.dtype)
    return torch.matmul(onehot, mapping)
