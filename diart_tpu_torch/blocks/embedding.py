"""Overlap-aware speaker embedding blocks (port of
``diart_tpu/blocks/embedding.py``; diart's ``blocks/embedding.py``).

As in the JAX package, the trunk runs once per chunk and only the weighted
statistics pooling fans out per speaker (the model's ``head``), where diart
repeats the waveform once per speaker. The blocks run on the model's device
and return tensors there.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..features import TemporalFeatureFormatter, TemporalFeatures
from ..models import EmbeddingModel
from ..ops.functional import (
    min_max_normalize,
    normalize_embeddings,
    overlapped_speech_penalty,
)
from ..parallel.engine import to_device
from .utils import resolve_device

__all__ = [
    "SpeakerEmbedding",
    "OverlappedSpeechPenalty",
    "EmbeddingNormalization",
    "OverlapAwareSpeakerEmbedding",
]


class SpeakerEmbedding:
    """Embed each speaker of a chunk given per-frame weights
    (diart's ``embedding.py:11-68``)."""

    def __init__(self, model: EmbeddingModel, device=None):
        self.model = model
        self.device = resolve_device([model], device)
        self.waveform_formatter = TemporalFeatureFormatter()
        self.weights_formatter = TemporalFeatureFormatter()

    @staticmethod
    def from_pretrained(
        model, use_hf_token: Union[str, bool, None] = True, device="cuda"
    ) -> "SpeakerEmbedding":
        return SpeakerEmbedding(EmbeddingModel.from_pretrained(model, use_hf_token, device=device))

    @torch.no_grad()
    def __call__(
        self, waveform: TemporalFeatures, weights: Optional[TemporalFeatures] = None
    ) -> torch.Tensor:
        """waveform (batch, samples, ch); weights (batch, frames, speakers)
        -> (batch, speakers, dim); without weights -> (batch, dim). Unit
        dims are squeezed away like diart's ``output.squeeze()``
        (embedding.py:68): single-chunk callers get (speakers, dim)."""
        wave = to_device(self.waveform_formatter.cast(waveform), self.device).transpose(1, 2)
        if self.model.host_only:
            # a host-only (ONNX) model: diart's waveform repeated per speaker
            # through the model's call (models.py:248-265); there is no
            # trunk/head to split
            wave_np = wave.cpu().numpy()
            if weights is None:
                out = np.asarray(self.model(wave_np))
            else:
                w = self.weights_formatter.cast(weights).cpu().numpy()
                b, _, k = w.shape
                w_flat = np.swapaxes(w, 1, 2).reshape(b * k, -1)
                out = np.asarray(self.model(np.repeat(wave_np, k, axis=0), w_flat)).reshape(b, k, -1)
            return torch.as_tensor(out, device=self.device).squeeze()
        frames = self.model.trunk(wave)
        if weights is None:
            return self.model.head(frames).squeeze()
        w = to_device(self.weights_formatter.cast(weights), self.device).transpose(1, 2)  # (B, S, T)
        return self.model.head(frames, w).squeeze()


class OverlappedSpeechPenalty:
    """Paper Eq. 2 weights (diart's ``embedding.py:71-107``), computed on
    ``device``; the caller's container comes back."""

    def __init__(self, gamma: float = 3.0, beta: float = 10.0, normalize: bool = False,
                 device="cuda"):
        self.gamma = gamma
        self.beta = beta
        self.normalize = normalize
        self.device = resolve_device([], device)
        self.formatter = TemporalFeatureFormatter()

    def __call__(self, segmentation: TemporalFeatures) -> TemporalFeatures:
        scores = to_device(self.formatter.cast(segmentation), self.device)
        weights = overlapped_speech_penalty(scores, self.gamma, self.beta)
        if self.normalize:
            weights = min_max_normalize(weights, dim=-2)
        return self.formatter.restore_type(weights)


class EmbeddingNormalization:
    """Rescale embeddings to a target norm (diart's ``embedding.py:110-120``)."""

    def __init__(self, norm: Union[float, np.ndarray, torch.Tensor] = 1.0):
        self.norm = norm
        if hasattr(self.norm, "ndim") and self.norm.ndim == 2:
            self.norm = self.norm[None]

    def __call__(self, embeddings: torch.Tensor) -> torch.Tensor:
        norm = self.norm
        if not isinstance(norm, (int, float)):
            norm = torch.as_tensor(norm, dtype=embeddings.dtype, device=embeddings.device)
        return normalize_embeddings(embeddings, norm)


class OverlapAwareSpeakerEmbedding:
    """OSP -> weighted embedding -> normalization (diart's
    ``embedding.py:123-178``), on the model's device."""

    def __init__(
        self,
        model: EmbeddingModel,
        gamma: float = 3.0,
        beta: float = 10.0,
        norm: Union[float, np.ndarray, torch.Tensor] = 1.0,
        normalize_weights: bool = False,
        device=None,
    ):
        self.embedding = SpeakerEmbedding(model, device)
        self.osp = OverlappedSpeechPenalty(gamma, beta, normalize_weights, self.embedding.device)
        self.normalize = EmbeddingNormalization(norm)

    @staticmethod
    def from_pretrained(
        model,
        gamma: float = 3.0,
        beta: float = 10.0,
        norm: Union[float, np.ndarray, torch.Tensor] = 1.0,
        use_hf_token: Union[str, bool, None] = True,
        normalize_weights: bool = False,
        device="cuda",
    ) -> "OverlapAwareSpeakerEmbedding":
        return OverlapAwareSpeakerEmbedding(
            EmbeddingModel.from_pretrained(model, use_hf_token, device=device),
            gamma,
            beta,
            norm,
            normalize_weights,
        )

    def __call__(self, waveform: TemporalFeatures, segmentation: TemporalFeatures) -> torch.Tensor:
        return self.normalize(self.embedding(waveform, self.osp(segmentation)))
