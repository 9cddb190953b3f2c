"""Local<->global speaker assignment algebra (host-exact path).

A numpy copy of ``diart_tpu/blocks/mapping.py``. Behavioral equivalent of
diart's ``SpeakerMap`` / ``SpeakerMapBuilder`` (diart's ``mapping.py``): a
cost/score matrix between source
(local) and target (global) speakers plus an objective, solved with the
Hungarian algorithm, with "unmapping" expressed by writing the objective's
invalid value into rows/columns.

This host implementation is the correctness oracle for the fixed-shape
on-device clustering (:mod:`diart_tpu_torch.ops.clustering`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = [
    "SpeakerMap",
    "SpeakerMapBuilder",
    "MappingMatrixObjective",
    "MinimizationObjective",
    "MaximizationObjective",
]

# Hungarian solvers dislike inf; a large sentinel marks invalid entries
# (same convention as the reference, mapping.py:49-52).
_INVALID_MAX = -1e10
_INVALID_MIN = 1e10


class MappingMatrixObjective:
    """Optimization-direction descriptor (reference ``mapping.py:11-98``).

    Our :class:`SpeakerMap` carries the direction and best value as plain
    constructor arguments, so these classes are thin factories kept for
    API parity with reference code that passes objectives around.
    """

    maximize: bool = False
    best_possible_value: float = 0.0

    @property
    def invalid_value(self) -> float:
        return _INVALID_MAX if self.maximize else _INVALID_MIN

    def invalid_tensor(self, shape: Union[Tuple, int]) -> np.ndarray:
        return np.full(shape, self.invalid_value)

    def optimal_assignments(self, matrix: np.ndarray) -> List[int]:
        return list(linear_sum_assignment(matrix, self.maximize)[1])

    def mapped_indices(self, matrix: np.ndarray, axis: int) -> List[int]:
        best_fn = np.max if self.maximize else np.min
        best_values = best_fn(matrix, axis=axis)
        return list(np.where(best_values != self.invalid_value)[0])

    def hard_speaker_map(
        self, num_src: int, num_tgt: int, assignments: Iterable[Tuple[int, int]]
    ) -> "SpeakerMap":
        matrix = self.invalid_tensor((num_src, num_tgt))
        for src, tgt in assignments:
            matrix[src, tgt] = self.best_possible_value
        return SpeakerMap(matrix, self.maximize, self.best_possible_value)


class MinimizationObjective(MappingMatrixObjective):
    maximize = False
    best_possible_value = 0.0


class MaximizationObjective(MappingMatrixObjective):
    maximize = True

    def __init__(self, max_value: float = 1.0):
        self.best_possible_value = max_value


def _cosine_cdist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    # deliberately NOT clamped: a zero-norm vector yields NaN distances,
    # matching both scipy's cdist (the reference's engine, mapping.py:170)
    # and the device path (ops/functional.cosine_cdist) — this file is the
    # device paths' correctness oracle, so the degenerate case must agree
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
        yn = y / np.linalg.norm(y, axis=-1, keepdims=True)
    return 1.0 - xn @ yn.T


class SpeakerMap:
    """An assignment problem between source and target speakers.

    ``maximize=False`` treats the matrix as costs (lower is better),
    ``maximize=True`` as scores. The optimal assignment is recomputed lazily
    whenever the matrix changes — mirroring the reference's lazy
    ``_raw_optimal_assignments`` (``mapping.py:193-199``), including the
    subtle consequence that editing the matrix can reshuffle *other* rows'
    assignments.
    """

    def __init__(
        self,
        matrix: np.ndarray,
        maximize: bool = False,
        best_value: Optional[float] = None,
    ):
        self.matrix = np.asarray(matrix, dtype=float)
        self.maximize = maximize
        # value written by set_source_speaker to force an assignment;
        # None defaults by objective direction — an EXPLICIT 0.0 from a
        # MaximizationObjective(max_value=0.0) must be respected, not
        # coerced to 1.0
        self.best_value = (
            (1.0 if maximize else 0.0) if best_value is None else best_value
        )
        self._assignments: Optional[List[int]] = None

    # ------------------------------------------------------------------ #
    @property
    def invalid_value(self) -> float:
        return _INVALID_MAX if self.maximize else _INVALID_MIN

    @property
    def shape(self) -> Tuple[int, int]:
        return self.matrix.shape

    @property
    def num_source_speakers(self) -> int:
        return self.matrix.shape[0]

    @property
    def num_target_speakers(self) -> int:
        return self.matrix.shape[1]

    def _solve(self) -> List[int]:
        if self._assignments is None:
            _, cols = linear_sum_assignment(self.matrix, maximize=self.maximize)
            self._assignments = list(cols)
        return self._assignments

    def _row_mapped(self, src: int) -> bool:
        """Loose validity: the row contains at least one valid entry
        (mapping.py:18-21: mapped rows are those whose best value is not the
        invalid sentinel)."""
        best = np.max(self.matrix[src]) if self.maximize else np.min(self.matrix[src])
        return best != self.invalid_value

    # ------------------------------------------------------------------ #
    def valid_assignments(
        self, strict: bool = False
    ) -> Tuple[List[int], List[int]]:
        sources, targets = [], []
        for src, tgt in enumerate(self._solve()):
            if strict:
                ok = self.matrix[src, tgt] != self.invalid_value
            else:
                ok = self._row_mapped(src)
            if ok:
                sources.append(src)
                targets.append(tgt)
        return sources, targets

    def to_dict(self, strict: bool = False) -> Dict[int, int]:
        return dict(zip(*self.valid_assignments(strict)))

    def is_source_speaker_mapped(self, src: int) -> bool:
        return self._row_mapped(src)

    def is_target_speaker_mapped(self, tgt: int) -> bool:
        """Column validity (mapping.py:242-243): the column holds at least
        one valid entry."""
        col = self.matrix[:, tgt]
        best = np.max(col) if self.maximize else np.min(col)
        return best != self.invalid_value

    def __len__(self) -> int:
        return sum(1 for s in range(self.num_source_speakers) if self._row_mapped(s))

    # ------------------------------------------------------------------ #
    # Matrix edits (each returns a new map, as in the reference)
    # ------------------------------------------------------------------ #
    def set_source_speaker(self, src: int, tgt: int) -> "SpeakerMap":
        matrix = self.matrix.copy()
        matrix[src, tgt] = self.best_value
        return SpeakerMap(matrix, self.maximize, self.best_value)

    def unmap_source_speaker(self, src: int) -> "SpeakerMap":
        return self.unmap_speakers([src])

    def unmap_speakers(
        self,
        sources: Optional[Union[Sequence[int], np.ndarray]] = None,
        targets: Optional[Union[Sequence[int], np.ndarray]] = None,
    ) -> "SpeakerMap":
        matrix = self.matrix.copy()
        # `is None`, not truthiness: numpy arrays (which the reference
        # passes, clustering.py:163-166) are ambiguous or, for a single
        # falsy element, silently skipped under `or []`
        for s in list(sources) if sources is not None else []:
            matrix[int(s), :] = self.invalid_value
        for t in list(targets) if targets is not None else []:
            matrix[:, int(t)] = self.invalid_value
        return SpeakerMap(matrix, self.maximize, self.best_value)

    def unmap_threshold(self, threshold: float) -> "SpeakerMap":
        """Unmap source speakers whose assigned value is no better than
        ``threshold`` (mapping.py:260-273)."""
        bad = []
        for src, tgt in zip(*self.valid_assignments()):
            val = self.matrix[src, tgt]
            if (self.maximize and val <= threshold) or (
                not self.maximize and val >= threshold
            ):
                bad.append(src)
        return self.unmap_speakers(bad)

    def compose(self, other: "SpeakerMap") -> "SpeakerMap":
        """Chain ``self`` (src -> mid) with ``other`` (mid -> tgt)."""
        matrix = np.full(
            (self.num_source_speakers, other.num_target_speakers),
            other.invalid_value,
        )
        for src, mid in zip(*self.valid_assignments()):
            matrix[src] = other.matrix[mid]
        return SpeakerMap(matrix, other.maximize, other.best_value)

    def union(self, other: "SpeakerMap") -> "SpeakerMap":
        """Hard map keeping ``self``'s assignments and adding ``other``'s
        non-conflicting ones (mapping.py:310-339)."""
        assert self.shape == other.shape
        matrix = np.full(self.shape, self.invalid_value)
        self_src, self_tgt = self.valid_assignments()
        other_map = other.to_dict()
        for src in range(self.num_source_speakers):
            if src in self_src:
                matrix[src, self_tgt[self_src.index(src)]] = self.best_value
            elif src in other_map and not self.is_target_speaker_mapped(
                other_map[src]
            ):
                matrix[src, other_map[src]] = self.best_value
        return SpeakerMap(matrix, self.maximize, self.best_value)

    def __add__(self, other: "SpeakerMap") -> "SpeakerMap":
        return self.union(other)

    # ------------------------------------------------------------------ #
    def apply(self, source_scores: np.ndarray) -> np.ndarray:
        """Project ``(frames, sources)`` scores onto target columns; unmapped
        targets stay zero (mapping.py:341-360)."""
        # unwrap SlidingWindowFeature (np.ndarray.data is a memoryview!)
        if hasattr(source_scores, "sliding_window"):
            data = source_scores.data
        else:
            data = np.asarray(source_scores)
        out = np.zeros((data.shape[0], self.num_target_speakers), dtype=data.dtype)
        for src, tgt in zip(*self.valid_assignments()):
            out[:, tgt] = data[:, src]
        return out


class SpeakerMapBuilder:
    """Constructors for :class:`SpeakerMap` (mapping.py:101-176)."""

    @staticmethod
    def hard_map(
        shape: Tuple[int, int],
        assignments: Iterable[Tuple[int, int]],
        maximize: bool,
    ) -> SpeakerMap:
        matrix = np.full(shape, _INVALID_MAX if maximize else _INVALID_MIN)
        best = 1.0 if maximize else 0.0
        for src, tgt in assignments:
            matrix[src, tgt] = best
        return SpeakerMap(matrix, maximize, best)

    @staticmethod
    def dist(
        embeddings1: np.ndarray, embeddings2: np.ndarray, metric: str = "cosine"
    ) -> SpeakerMap:
        if metric == "cosine":
            matrix = _cosine_cdist(embeddings1, embeddings2)
        elif metric == "euclidean":
            diff = embeddings1[:, None, :] - embeddings2[None, :, :]
            matrix = np.linalg.norm(diff, axis=-1)
        else:
            from scipy.spatial.distance import cdist

            matrix = cdist(embeddings1, embeddings2, metric=metric)
        return SpeakerMap(matrix, maximize=False)

    @staticmethod
    def correlation(scores1: np.ndarray, scores2: np.ndarray) -> SpeakerMap:
        """Frame-correlation score matrix normalized by local speech totals
        (mapping.py:128-144)."""
        corr = scores1.T @ scores2  # (src, tgt)
        local_totals = np.sum(scores1, axis=0).reshape(-1, 1)
        return SpeakerMap(corr / local_totals, maximize=True, best_value=1.0)

    @staticmethod
    def mse(scores1: np.ndarray, scores2: np.ndarray) -> SpeakerMap:
        diff = scores1[:, :, None] - scores2[:, None, :]  # (frames, src, tgt)
        return SpeakerMap(np.mean(diff**2, axis=0), maximize=False)

    @staticmethod
    def mae(scores1: np.ndarray, scores2: np.ndarray) -> SpeakerMap:
        diff = scores1[:, :, None] - scores2[:, None, :]
        return SpeakerMap(np.mean(np.abs(diff), axis=0), maximize=False)
