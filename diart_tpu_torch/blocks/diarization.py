"""Streaming speaker diarization pipeline (port of
``diart_tpu/blocks/diarization.py``; diart's ``blocks/diarization.py``).

The same composition (segmentation -> overlap-aware embedding -> online
clustering -> delayed aggregation -> binarize -> timestamp shift) and the
same defaults (tau 0.6, rho 0.3, delta 1, gamma 3, beta 10, 20 speakers,
16 kHz, latency in [step, duration]).

A call on N consecutive chunks runs in two parts:

* :meth:`SpeakerDiarization.dispatch` copies the (N, samples, 1) batch to
  the device once (pinned, no host wait), runs segmentation and the
  embedding trunk and head for all N chunks at once, and advances the
  clustering chunk by chunk with the batched ``ops.clustering.cluster_step``
  (a stream axis of 1). The clustering state stays on the device from call
  to call, and nothing here waits for the card;
* :meth:`SpeakerDiarization.fetch` copies the permuted scores (N, frames,
  speakers) to the host once and runs the host loop: delayed aggregation,
  binarize, timestamp shift.

For many concurrent streams use :class:`diart_tpu_torch.MultiStreamEngine`,
which fuses the whole loop, aggregation included, into one step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.annotation import Annotation
from ..core.segment import SlidingWindowFeature
from ..metrics import BaseMetric, DiarizationErrorRate
from ..models import EmbeddingModel, SegmentationModel
from ..ops.clustering import ClusteringParams, cluster_step, init_state
from ..ops.functional import (
    min_max_normalize,
    normalize_embeddings,
    overlapped_speech_penalty,
)
from ..parallel.engine import to_device
from . import base
from .utils import resolve_device

__all__ = ["SpeakerDiarizationConfig", "SpeakerDiarization"]


def stack_chunks(waveforms: Sequence[SlidingWindowFeature], duration: float, sample_rate: int) -> np.ndarray:
    """The chunks' samples as one (N, samples, channels) float32 array."""
    assert len(waveforms) >= 1, "Pipeline expected at least 1 input"
    batch = np.stack([np.asarray(w.data, np.float32) for w in waveforms])
    expected = int(np.rint(duration * sample_rate))
    assert batch.shape[1] == expected, (
        f"Expected {expected} samples per chunk, but got {batch.shape[1]}"
    )
    return batch


class SpeakerDiarizationConfig(base.PipelineConfig):
    """Hyper-parameters and resources (diart's ``diarization.py:21-86``).

    device: where the pipeline runs. Models that are passed in set it (a
    ``device`` that is not theirs raises); without models it defaults to the
    card, where ``tpu/pyannet`` and ``tpu/xvector`` are built. The forward's
    numerics follow the precision policy active at call time
    (``diart_tpu_torch.precision.use``).
    """

    def __init__(
        self,
        segmentation: Optional[SegmentationModel] = None,
        embedding: Optional[EmbeddingModel] = None,
        duration: float = 5.0,
        step: float = 0.5,
        latency: Optional[Union[float, str]] = None,
        tau_active: float = 0.6,
        rho_update: float = 0.3,
        delta_new: float = 1.0,
        gamma: float = 3.0,
        beta: float = 10.0,
        max_speakers: int = 20,
        normalize_embedding_weights: bool = False,
        device=None,
        sample_rate: int = 16000,
        **kwargs,
    ):
        super().__init__(duration, step, latency, sample_rate)
        self.device = resolve_device([segmentation, embedding], device)
        self.segmentation = segmentation or SegmentationModel.from_pretrained(
            "tpu/pyannet", device=self.device
        )
        self.embedding = embedding or EmbeddingModel.from_pretrained(
            "tpu/xvector", device=self.device
        )
        self.tau_active = tau_active
        self.rho_update = rho_update
        self.delta_new = delta_new
        self.gamma = gamma
        self.beta = beta
        self.max_speakers = max_speakers
        self.normalize_embedding_weights = normalize_embedding_weights


class SpeakerDiarization(base.Pipeline):
    """The flagship pipeline (diart's ``diarization.py:89-234``)."""

    def __init__(self, config: Optional[SpeakerDiarizationConfig] = None):
        self._config = SpeakerDiarizationConfig() if config is None else config
        self.device = self._config.device
        self._init_aggregation()
        self.clustering_state = None
        self.reset()

    # ------------------------------------------------------------------ #
    @staticmethod
    def get_config_class() -> type:
        return SpeakerDiarizationConfig

    @staticmethod
    def suggest_metric() -> BaseMetric:
        return DiarizationErrorRate(collar=0, skip_overlap=False)

    @staticmethod
    def hyper_parameters() -> Sequence[base.HyperParameter]:
        return [base.TauActive, base.RhoUpdate, base.DeltaNew]

    @property
    def config(self) -> SpeakerDiarizationConfig:
        return self._config

    def set_timestamp_shift(self, shift: float):
        self.timestamp_shift = shift

    def reset(self):
        """Back to an empty stream. The clustering parameters are rebuilt from
        the config, as diart's reset() rebuilds its clustering
        (diarization.py:146-155): callers that change the config's
        hyper-parameters between files expect reset to pick them up."""
        self.set_timestamp_shift(0.0)
        cfg = self._config
        self._cluster_params = ClusteringParams(cfg.tau_active, cfg.rho_update, cfg.delta_new)
        self.clustering_state = init_state(
            1, cfg.max_speakers, cfg.embedding.embedding_dim, device=self.device
        )
        self.chunk_buffer, self.pred_buffer = [], []

    # ------------------------------------------------------------------ #
    def _forward(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, samples, channels) -> seg (N, F, K), emb (N, K, E). A host-only
        (ONNX) model takes numpy on the host; a host embedding model gets the
        waveform once per speaker with that speaker's weights, as diart
        batches its embeddings (blocks/embedding.py:54-65)."""
        cfg = self._config
        wave = batch.transpose(1, 2)  # (N, ch, samples)
        if cfg.segmentation.host_only:
            seg = torch.as_tensor(np.asarray(cfg.segmentation(wave.cpu().numpy())), device=batch.device)
        else:
            seg = cfg.segmentation(wave)
        weights = overlapped_speech_penalty(seg, cfg.gamma, cfg.beta)
        if cfg.normalize_embedding_weights:
            weights = min_max_normalize(weights, dim=-2)
        if cfg.embedding.host_only:
            n, k = seg.shape[0], seg.shape[2]
            wave_rep = np.repeat(wave.cpu().numpy(), k, axis=0)  # (N*K, ch, samples)
            w_flat = weights.transpose(1, 2).reshape(n * k, -1).cpu().numpy()
            emb = np.asarray(cfg.embedding(wave_rep, w_flat))
            emb = torch.as_tensor(emb, device=batch.device).reshape(n, k, -1)
        else:
            frames = cfg.embedding.trunk(wave)
            emb = cfg.embedding.head(frames, weights.transpose(1, 2))
        return seg, normalize_embeddings(emb, 1.0)

    @torch.no_grad()
    def dispatch(self, waveforms: Sequence[SlidingWindowFeature]) -> torch.Tensor:
        """Queue the device work of a call on consecutive chunks and return
        their permuted scores (N, frames, max_speakers) on the device,
        advancing the clustering state; waits for nothing on the card."""
        cfg = self._config
        batch = to_device(stack_chunks(waveforms, cfg.duration, cfg.sample_rate), self.device)
        segmentations, embeddings = self._forward(batch)
        dim = embeddings.shape[-1]
        if dim != self.clustering_state.centers.shape[-1]:
            # a host-only embedding model tells its dimension at its first
            # call: the empty clustering state is rebuilt to match
            if bool(self.clustering_state.initialized.any()):
                raise RuntimeError(
                    f"embedding dim changed mid-stream: {self.clustering_state.centers.shape[-1]} -> {dim}"
                )
            self.clustering_state = init_state(1, cfg.max_speakers, dim, device=self.device)
        permuted = []
        for n in range(segmentations.shape[0]):
            self.clustering_state, scores, _ = cluster_step(
                self.clustering_state, segmentations[n : n + 1], embeddings[n : n + 1],
                self._cluster_params,
            )
            permuted.append(scores)
        return torch.cat(permuted)

    def fetch(
        self, waveforms: Sequence[SlidingWindowFeature], permuted: torch.Tensor
    ) -> List[Tuple[Annotation, SlidingWindowFeature]]:
        """Copy :meth:`dispatch`'s scores to the host (once) and build each
        chunk's (annotation, aggregated audio) pair."""
        return self._aggregate(waveforms, permuted.cpu().numpy())

    def __call__(
        self, waveforms: Sequence[SlidingWindowFeature]
    ) -> List[Tuple[Annotation, SlidingWindowFeature]]:
        return self.fetch(waveforms, self.dispatch(waveforms))
