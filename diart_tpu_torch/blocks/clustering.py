"""Online speaker clustering — host-exact stateful block (a numpy copy of
``diart_tpu/blocks/clustering.py``).

Behavioral equivalent of diart's ``OnlineSpeakerClustering`` (diart's
``blocks/clustering.py:10-218``). This is the correctness oracle for the
fixed-shape device implementation in :mod:`diart_tpu_torch.ops.clustering`;
the engine and the pipelines use the device path.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from ..core.segment import SlidingWindowFeature
from .mapping import SpeakerMap, SpeakerMapBuilder

__all__ = ["OnlineSpeakerClustering"]


class OnlineSpeakerClustering:
    """Constrained incremental centroid clustering of speaker embeddings.

    Per chunk: local speakers whose max activation reaches ``tau_active`` are
    matched to global centroids by cosine distance (Hungarian assignment,
    capped at ``delta_new``); unmatched *long* speakers (mean activation >=
    ``rho_update``) spawn new centroids while capacity remains, other
    unmatched speakers fall back to the closest free centroid; matched long
    speakers update their centroid by embedding summation.
    """

    def __init__(
        self,
        tau_active: float,
        rho_update: float,
        delta_new: float,
        metric: str = "cosine",
        max_speakers: int = 20,
    ):
        self.tau_active = tau_active
        self.rho_update = rho_update
        self.delta_new = delta_new
        self.metric = metric
        self.max_speakers = max_speakers
        self.centers: Optional[np.ndarray] = None
        self.active_centers: Set[int] = set()
        self.blocked_centers: Set[int] = set()

    @property
    def num_known_speakers(self) -> int:
        return len(self.active_centers)

    @property
    def num_blocked_speakers(self) -> int:
        return len(self.blocked_centers)

    @property
    def num_free_centers(self) -> int:
        return self.max_speakers - self.num_known_speakers - self.num_blocked_speakers

    @property
    def inactive_centers(self) -> List[int]:
        return [
            c
            for c in range(self.max_speakers)
            if c not in self.active_centers or c in self.blocked_centers
        ]

    def get_next_center_position(self) -> Optional[int]:
        for c in range(self.max_speakers):
            if c not in self.active_centers and c not in self.blocked_centers:
                return c
        return None

    def init_centers(self, dimension: int) -> None:
        self.centers = np.zeros((self.max_speakers, dimension))
        self.active_centers = set()
        self.blocked_centers = set()

    def add_center(self, embedding: np.ndarray) -> Optional[int]:
        center = self.get_next_center_position()
        if center is None:
            # no free slot: refuse instead of the reference's latent
            # corruption (``self.centers[None] = embedding`` broadcasts the
            # embedding over EVERY centroid row and poisons the active set)
            return None
        self.centers[center] = embedding
        self.active_centers.add(center)
        return center

    def update(
        self, assignments: List[Tuple[int, int]], embeddings: np.ndarray
    ) -> None:
        """Accumulate embeddings into assigned centroids (sums, not means —
        cosine distance is scale-invariant; clustering.py:96-99)."""
        if self.centers is None:
            return
        for l_spk, g_spk in assignments:
            assert g_spk in self.active_centers, "cannot update unknown centers"
            self.centers[g_spk] += embeddings[l_spk]

    def identify(
        self, segmentation: SlidingWindowFeature, embeddings: np.ndarray
    ) -> SpeakerMap:
        embeddings = np.asarray(embeddings)
        data = segmentation.data
        active = np.where(np.max(data, axis=0) >= self.tau_active)[0]
        long = np.where(np.mean(data, axis=0) >= self.rho_update)[0]
        finite = np.where(~np.isnan(embeddings).any(axis=1))[0]
        active = np.intersect1d(active, finite)
        num_local = data.shape[1]

        # First chunk: adopt every active speaker (regardless of rho).
        if self.centers is None:
            self.init_centers(embeddings.shape[1])
            assignments = [
                (int(s), g)
                for s in active
                if (g := self.add_center(embeddings[s])) is not None
            ]
            return SpeakerMapBuilder.hard_map(
                (num_local, self.max_speakers), assignments, maximize=False
            )

        dist_map = SpeakerMapBuilder.dist(embeddings, self.centers, self.metric)
        inactive_local = [s for s in range(num_local) if s not in active]
        dist_map = dist_map.unmap_speakers(inactive_local, self.inactive_centers)
        valid_map = dist_map.unmap_threshold(self.delta_new)

        missed = [s for s in active if not valid_map.is_source_speaker_mapped(s)]

        new_center_speakers: List[int] = []
        for spk in missed:
            if len(new_center_speakers) < self.num_free_centers and spk in long:
                new_center_speakers.append(spk)
                continue
            # Fall back to the closest *free* active centroid, ordered by the
            # unthresholded distances (clustering.py:183-194).
            preferences = [
                g
                for g in np.argsort(dist_map.matrix[spk, :])
                if g in self.active_centers
            ]
            _, taken = valid_map.valid_assignments()
            free = [g for g in preferences if g not in taken]
            if free:
                valid_map = valid_map.set_source_speaker(spk, int(free[0]))

        to_update = [
            (ls, gs)
            for ls, gs in zip(*valid_map.valid_assignments())
            if ls not in missed and ls in long
        ]
        self.update(to_update, embeddings)

        for spk in new_center_speakers:
            valid_map = valid_map.set_source_speaker(
                spk, self.add_center(embeddings[spk])
            )
        return valid_map

    def __call__(
        self, segmentation: SlidingWindowFeature, embeddings: np.ndarray
    ) -> SlidingWindowFeature:
        """Permute local segmentation scores onto global speaker columns."""
        return SlidingWindowFeature(
            self.identify(segmentation, embeddings).apply(segmentation.data),
            segmentation.sliding_window,
        )
