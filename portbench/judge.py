"""The comparison that decides ``correct``.

A run keeps, for a sample of streams drawn from the seed, what the timed
path produced at every hop: the step's aggregated scores of the stream
(``num_out`` frames x global speakers) and its RTTM text. Once the window
has closed, the plain reference (``portbench/reference``) recomputes every
window those streams heard from the raw weights and audio, and each hop is
judged by what it says. Two numbers, each the widest over all judged
hops, are held to the configuration's limits:

* ``score_gap``: the served scores and text against the reference's
  segmentation, in units of a score. The global column each local speaker
  went to is the clustering's choice, so the served columns are matched to
  the reference's local speakers by the map of least widest gap (at most
  one column each; an unmatched column counts its own scores, an unmatched
  speaker the height by which the reference puts its peak above
  ``tau_active``, a matched one the height by which it puts it below).
  Then the RTTM text, parsed back onto the hop's frame grid, against the
  reference's scores on the matched columns: the widest distance from
  ``tau_active`` of a reference score on the other side of it from the
  text. A malformed text, one that names another stream or falls off the
  grid reads infinite. Covers the audio ring, SincNet, the BiLSTM, the
  classifier, the permutation, the aggregation, binarization and the
  text's assembly. (With random weights an active speaker's score lies
  near 0.5, far from ``tau_active``, so a loss of precision moves the
  scores but flips no text; the text's part catches faults of the text.)
* ``cluster_gap``: the clustering replayed on the reference's embeddings
  along the served map. At each hop, the served assignment's total cosine
  distance above the least one, and how far past ``delta_new`` a served
  choice lies on the wrong side of it; once the window has closed, the
  served centroids (the session's state: sums of unit embeddings) against
  the replay's, as the widest element of their difference over the number
  of embeddings summed. On a stream's first chunk the map must found
  centroids in order, a new centroid must take the first free slot, and the
  served centroids in use must be the replay's (else infinite). Covers the
  embedding, the OSP weights and the clustering.

With random weights every speaker's activation lies near 0.5 and the
embeddings of one window nearly coincide, so the least and the next
assignment can differ by rounding alone: the replay judges whether the
served assignment is among the least, not whether it is the reference's,
and it follows the served map, so the centroids it builds are the
reference's sums along the program's choices.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional

import numpy as np

from .reference.online import Geometry, cosine_distances, min_assignment, parse_rttm

NUMBERS = ("score_gap", "cluster_gap")


class StreamJudge:
    """One stream's hops, judged in chunk order."""

    def __init__(self, uri: str, geometry: Geometry, speakers: int, hyper: dict):
        self.uri, self.geometry, self.speakers = uri, geometry, speakers
        self.tau, self.rho, self.delta = hyper["tau_active"], hyper["rho_update"], hyper["delta_new"]
        self.gaps = dict.fromkeys(NUMBERS, 0.0)
        self.hops = 0
        self.centers: Optional[np.ndarray] = None
        self.active = np.zeros(speakers, bool)
        self.summed = np.zeros(speakers)
        self.last_chunk = -1

    def _note(self, name: str, value: float) -> None:
        self.gaps[name] = max(self.gaps[name], float(value))

    def _match(self, agg: np.ndarray, seg: np.ndarray):
        """(least widest gap, target column of each local speaker or -1)."""
        focus = seg[self.geometry.focus]  # (num_out, K)
        peak = seg.max(axis=0)
        cols = np.flatnonzero(np.abs(agg).max(axis=0) > 0)
        k = seg.shape[1]
        if len(cols) > k:
            return math.inf, -np.ones(k, int)
        diff = np.abs(focus[:, :, None] - agg[:, cols][:, None, :]).max(axis=0)  # (K, cols)
        col_alone = np.abs(agg[:, cols]).max(axis=0)
        best, pick = math.inf, None
        for choice in itertools.product(range(-1, len(cols)), repeat=k):
            used = [c for c in choice if c >= 0]
            if len(used) != len(set(used)):
                continue
            gap = 0.0
            for local, c in enumerate(choice):
                gap = max(gap, diff[local, c], self.tau - peak[local]) if c >= 0 \
                    else max(gap, peak[local] - self.tau)
            for c in set(range(len(cols))) - set(used):
                gap = max(gap, col_alone[c])
            if gap < best:
                best, pick = gap, choice
        targets = np.array([cols[c] if c >= 0 else -1 for c in pick])
        return best, targets

    def _text(self, text: Optional[str], chunk: int, seg: np.ndarray, targets: np.ndarray) -> float:
        g = self.geometry
        rows = g.first if chunk == 0 else g.focus
        res = g.first_resolution if chunk == 0 else g.out_resolution
        ref = np.zeros((len(rows), self.speakers))
        for local, col in enumerate(targets):
            if col >= 0:
                ref[:, col] = seg[rows, local]
        if text is None:
            return math.inf
        bits = parse_rttm(text, self.uri, g.window_start(chunk), res, len(rows), self.speakers)
        if bits is None:
            return math.inf
        wrong = bits != (ref > self.tau)
        return float(np.abs(ref - self.tau)[wrong].max()) if wrong.any() else 0.0

    def _replay(self, chunk: int, seg: np.ndarray, emb: np.ndarray, targets: np.ndarray) -> float:
        mapped = [(k, int(c)) for k, c in enumerate(targets) if c >= 0]
        if chunk == 0 or self.centers is None:
            if chunk != 0 or [c for _, c in mapped] != list(range(len(mapped))):
                return math.inf
            self.centers = np.zeros((self.speakers, emb.shape[1]))
            for k, c in mapped:
                self.centers[c], self.active[c], self.summed[c] = emb[k], True, 1
            return 0.0
        gap = 0.0
        long = seg.mean(axis=0) >= self.rho
        dist = cosine_distances(emb, self.centers)
        cols = np.flatnonzero(self.active)
        old = [(k, c) for k, c in mapped if self.active[c]]
        new = [(k, c) for k, c in mapped if not self.active[c]]
        if old:
            rows = [k for k, _ in old]
            least, _ = min_assignment(dist[np.ix_(rows, cols)])
            gap = max(gap, sum(dist[k, c] for k, c in old) - least)
            gap = max(gap, max(dist[k, c] - self.delta for k, c in old))
        free = [c for c in range(self.speakers) if not self.active[c]]
        if [c for _, c in new] != free[:len(new)]:
            return math.inf
        for k, _ in new:
            if len(cols):
                gap = max(gap, self.delta - dist[k, cols].min())
        for k, c in old:
            if long[k]:
                self.centers[c] += emb[k]
                self.summed[c] += 1
        for k, c in new:
            self.centers[c], self.active[c], self.summed[c] = emb[k], True, 1
        return gap

    def hop(self, chunk: int, agg: np.ndarray, text: Optional[str], seg: np.ndarray, emb: np.ndarray) -> None:
        """Judge the hop that emitted chunk ``chunk``: the served scores
        ``agg`` (num_out, speakers), its text, and the reference's
        segmentation (frames, K) and unit embeddings (K, E) of its window."""
        if chunk != self.last_chunk + 1:
            raise ValueError(f"{self.uri}: chunk {chunk} after {self.last_chunk}")
        self.last_chunk = chunk
        self.hops += 1
        gap, targets = self._match(np.asarray(agg, np.float64), seg)
        self._note("score_gap", max(gap, self._text(text, chunk, seg, targets)))
        self._note("cluster_gap", self._replay(chunk, seg, emb, targets))

    def final(self, centers: np.ndarray, active: np.ndarray) -> None:
        """The served clustering state once the window has closed: centroid
        sums (speakers, E) and which are in use (speakers,)."""
        if self.centers is None or not np.array_equal(np.asarray(active, bool), self.active):
            self._note("cluster_gap", math.inf)
            return
        cols = np.flatnonzero(self.active)
        err = np.abs(np.asarray(centers, np.float64)[cols] - self.centers[cols]).max(axis=1)
        self._note("cluster_gap", float((err / np.maximum(self.summed[cols], 1)).max()) if len(cols) else 0.0)


def summary(judges: List[StreamJudge]) -> Dict[str, float]:
    """The widest of each number over every judged stream."""
    return {name: max(j.gaps[name] for j in judges) for name in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit, as the result line carries them."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else "inf", "limit": limits[k]}
            for k in NUMBERS}
