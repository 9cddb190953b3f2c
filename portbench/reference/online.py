"""diart's online pipeline after the models: incremental clustering with
optimal assignment, one-buffer aggregation geometry, binarization and RTTM
text, in NumPy (float64) and SciPy."""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import numpy as np

# --------------------------------------------------------------------- #
# Aggregation geometry (latency == step) and RTTM text
# --------------------------------------------------------------------- #
def _r(x: float) -> float:
    return round(x, 10)


class Geometry:
    """Which frames of a chunk a hop emits: the focus region (the last
    ``step`` seconds before the latency) on the output grid of ``num_out``
    frames a step, and on a stream's first chunk the whole region from 0,
    pyannote's 'loose' cropping."""

    def __init__(self, duration: float, step: float, latency: float, frames: int):
        if abs(latency - step) > 1e-9:
            raise ValueError("the reference aggregates one buffer only (latency == step)")
        res = duration / frames
        self.duration, self.step, self.latency, self.frames = duration, step, latency, frames
        self.num_out = int(math.floor(_r((step + res) / res)))
        start = int(math.ceil(_r((duration - latency - res) / res)))
        self.focus = np.clip(np.arange(start, start + self.num_out), 0, frames - 1)
        first = duration - latency + step
        i0 = int(math.ceil(_r(-res / res)))
        self.first = np.clip(np.arange(i0, i0 + int(math.floor(_r((first + res) / res)))), 0, frames - 1)
        self.out_resolution = step / self.num_out
        self.first_resolution = first / len(self.first)

    def window_start(self, chunk: int) -> float:
        """Start of chunk ``chunk``'s emitted region (the first chunk: 0)."""
        if chunk == 0:
            return 0.0
        return chunk * self.step + self.duration - self.latency


RTTM_LINE = re.compile(
    r"SPEAKER (\S+) 1 (-?\d+\.\d{3}) (\d+\.\d{3}) <NA> <NA> speaker(\d+) <NA> <NA>")


def parse_rttm(text: str, uri: str, start: float, resolution: float, frames: int, speakers: int):
    """An RTTM text of one stream's hop as (frames, speakers) activity: each
    turn runs from frame middle to frame middle on the hop's grid. None when
    a line is malformed, names another stream or a speaker beyond
    ``speakers``, or falls off the grid."""
    bits = np.zeros((frames, speakers), bool)
    for line in text.splitlines():
        m = RTTM_LINE.fullmatch(line.strip())
        if m is None or m.group(1) != uri:
            return None
        on, dur, spk = float(m.group(2)), float(m.group(3)), int(m.group(4))
        lo = (on - start - 0.5 * resolution) / resolution
        hi = (on + dur - start - 0.5 * resolution) / resolution
        i, j = int(round(lo)), int(round(hi))
        if spk >= speakers or abs(lo - i) > 0.2 or abs(hi - j) > 0.2 or not 0 <= i < j <= frames:
            return None
        bits[i:j, spk] = True
    return bits


def render_rttm(active: np.ndarray, uri: str, start: float, resolution: float) -> str:
    """(frames, speakers) activity -> RTTM text: a turn from the middle of
    its first active frame to the middle of the frame after its last, lines
    sorted by (start, end, track)."""
    ext = np.zeros((active.shape[0] + 2, active.shape[1]), np.int8)
    ext[1:-1] = active
    d = np.diff(ext.T, axis=1)
    on_spk, on_idx = np.nonzero(d == 1)
    _, off_idx = np.nonzero(d == -1)
    s = start + on_idx * resolution + 0.5 * resolution
    e = start + off_idx * resolution + 0.5 * resolution
    entries = sorted((s[t], e[t], str(t), int(on_spk[t])) for t in range(len(s)))
    return "".join(f"SPEAKER {uri} 1 {a:.3f} {b - a:.3f} <NA> <NA> speaker{k} <NA> <NA>\n"
                   for a, b, _, k in entries)


# --------------------------------------------------------------------- #
# Incremental clustering: the control's forward, and the judge's replay
# --------------------------------------------------------------------- #
def cosine_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xn = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    yn = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return 1.0 - xn @ yn.T


def min_assignment(cost: np.ndarray) -> Tuple[float, np.ndarray]:
    """The least total of an injective map of cost's rows to its columns
    (rows <= columns): (total, column of each row)."""
    from scipy.optimize import linear_sum_assignment

    if cost.shape[0] == 0:
        return 0.0, np.zeros(0, int)
    rows, cols = linear_sum_assignment(cost)
    pick = np.empty(cost.shape[0], int)
    pick[rows] = cols
    return float(cost[rows, cols].sum()), pick


class Clustering:
    """One stream's incremental clustering, diart's rules: a speaker is
    active when its peak activation reaches tau_active and long when its
    mean reaches rho_update; the first chunk's active speakers found
    centroids in order; later, active speakers take the centroids of least
    total cosine distance, a speaker farther than delta_new from its match
    founds a new centroid when long (else it takes the closest free one),
    and long assigned speakers add their embedding to their centroid."""

    def __init__(self, max_speakers: int, tau: float, rho: float, delta: float):
        self.m, self.tau, self.rho, self.delta = max_speakers, tau, rho, delta
        self.centers: Optional[np.ndarray] = None
        self.active = np.zeros(max_speakers, bool)

    def flags(self, seg: np.ndarray, emb: np.ndarray):
        active = (seg.max(axis=0) >= self.tau) & ~np.isnan(emb).any(axis=-1)
        return active, seg.mean(axis=0) >= self.rho

    def step(self, seg: np.ndarray, emb: np.ndarray) -> np.ndarray:
        """seg (frames, K), emb (K, E) -> the centroid of each local speaker
        (-1: none); the state advances."""
        active, long = self.flags(seg, emb)
        k = seg.shape[1]
        targets = -np.ones(k, int)
        if self.centers is None:
            self.centers = np.zeros((self.m, emb.shape[1]))
            for slot, row in enumerate(np.flatnonzero(active)[: self.m]):
                targets[row] = slot
                self.centers[slot] = emb[row]
                self.active[slot] = True
            return targets
        cols = np.flatnonzero(self.active)
        rows = np.flatnonzero(active)
        dist = cosine_distances(np.nan_to_num(emb), self.centers)
        valid = np.zeros(k, bool)
        if len(cols) and len(rows):
            sub = dist[np.ix_(rows, cols)]
            if len(rows) <= len(cols):
                _, pick = min_assignment(sub)
            else:  # more speakers than centroids: the best rows for each column
                _, pick_t = min_assignment(sub.T)
                pick = -np.ones(len(rows), int)
                pick[pick_t] = np.arange(len(cols))
            for r, c in zip(rows, pick):
                if c >= 0 and dist[r, cols[c]] < self.delta:
                    valid[r] = True
            vrows = rows[valid[rows]]
            _, pick = min_assignment(dist[np.ix_(vrows, cols)]) if len(vrows) else (0.0, [])
            for r, c in zip(vrows, pick):
                targets[r] = cols[c]
        taken = np.zeros(self.m, bool)
        taken[targets[targets >= 0]] = True
        free = self.m - self.active.sum()
        new = []
        for r in range(k):
            if not active[r] or valid[r]:
                continue
            if long[r] and len(new) < free:
                new.append(r)
                continue
            pref = np.where(self.active & ~taken, dist[r], np.inf)
            if np.isfinite(pref).any():
                targets[r] = int(np.argmin(pref))
                taken[targets[r]] = True
        for r in range(k):
            if valid[r] and long[r]:
                self.centers[targets[r]] += emb[r]
        for r in new:
            slot = int(np.argmin(self.active))
            self.centers[slot] = emb[r]
            self.active[slot] = True
            targets[r] = slot
        return targets


def permute(seg: np.ndarray, targets: np.ndarray, speakers: int) -> np.ndarray:
    """Local scores (frames, K) on the global columns (frames, speakers)."""
    out = np.zeros((seg.shape[0], speakers))
    for k, t in enumerate(targets):
        if t >= 0:
            out[:, t] += seg[:, k]
    return out
