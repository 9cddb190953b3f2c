"""Diarization evaluation metrics (a copy of ``diart_tpu/metrics/der.py``).

Self-contained reimplementation of the subset of ``pyannote.metrics`` used by
diart (``DiarizationErrorRate`` suggested at diart's
``blocks/diarization.py:131-133`` and ``DetectionErrorRate`` at
``blocks/vad.py:108-110``; report consumption at ``inference.py:359-390``
and ``optim.py:122``). pandas is imported by :meth:`BaseMetric.report`
only, so the pipelines, which suggest these metrics, import without it.

DER follows the NIST definition: with an optimal (Hungarian) one-to-one
mapping between reference and hypothesis speakers, for every elementary time
cell with ``r`` active reference speakers, ``h`` active hypothesis speakers
and ``c`` correctly matched speakers:

* missed detection += dur * max(0, r - h)
* false alarm      += dur * max(0, h - r)
* confusion        += dur * (min(r, h) - c)
* total            += dur * r

``DER = (miss + fa + conf) / total``. The evaluation region (UEM) defaults to
the hull of reference and hypothesis extents; an optional collar removes
``collar/2`` around every reference boundary; ``skip_overlap`` removes regions
with two or more simultaneous reference speakers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..core.annotation import Annotation, Timeline
from ..core.segment import Segment

__all__ = [
    "BaseMetric",
    "DiarizationErrorRate",
    "DetectionErrorRate",
]


def _evaluation_regions(
    reference: Annotation,
    hypothesis: Annotation,
    uem: Optional[Timeline],
    collar: float,
    skip_overlap: bool,
) -> Timeline:
    if uem is None:
        hull = reference.get_timeline().extent() | hypothesis.get_timeline().extent()
        uem = Timeline([hull]) if hull else Timeline([])
    regions = uem
    if collar > 0:
        # Remove collar/2 on each side of every reference boundary.
        half = 0.5 * collar
        removed = Timeline()
        for seg in reference.itersegments():
            removed.add(Segment(seg.start - half, seg.start + half))
            removed.add(Segment(seg.end - half, seg.end + half))
        regions = _subtract(regions, removed)
    if skip_overlap:
        overlap = _overlap_regions(reference)
        regions = _subtract(regions, overlap)
    return regions


def _subtract(regions: Timeline, removed: Timeline) -> Timeline:
    removed = removed.support()
    out = Timeline(uri=regions.uri)
    for seg in regions:
        pieces = [seg]
        for rem in removed:
            next_pieces = []
            for p in pieces:
                if not p.intersects(rem):
                    next_pieces.append(p)
                    continue
                left = Segment(p.start, min(p.end, rem.start))
                right = Segment(max(p.start, rem.end), p.end)
                if left:
                    next_pieces.append(left)
                if right:
                    next_pieces.append(right)
            pieces = next_pieces
        for p in pieces:
            out.add(p)
    return out


def _overlap_regions(annotation: Annotation) -> Timeline:
    """Regions where two or more tracks are simultaneously active."""
    bounds = sorted(
        {s.start for s in annotation.itersegments()}
        | {s.end for s in annotation.itersegments()}
    )
    out = Timeline()
    segs = list(annotation.itersegments())
    for a, b in zip(bounds[:-1], bounds[1:]):
        mid = 0.5 * (a + b)
        count = sum(1 for s in segs if s.start <= mid < s.end)
        if count >= 2:
            out.add(Segment(a, b))
    return out.support()


def _crop_to_regions(annotation: Annotation, regions: Timeline) -> Annotation:
    out = Annotation(uri=annotation.uri)
    i = 0
    for segment, _, label in annotation.itertracks(yield_label=True):
        for region in regions:
            inter = segment & region
            if inter:
                out[inter, i] = label
                i += 1
    return out


def _cells(
    reference: Annotation, hypothesis: Annotation
) -> List[Tuple[float, List[str], List[str]]]:
    """Elementary cells: (duration, active ref labels, active hyp labels)."""
    bounds = set()
    for seg in reference.itersegments():
        bounds.add(seg.start)
        bounds.add(seg.end)
    for seg in hypothesis.itersegments():
        bounds.add(seg.start)
        bounds.add(seg.end)
    bounds = sorted(bounds)
    ref_tracks = list(reference.itertracks(yield_label=True))
    hyp_tracks = list(hypothesis.itertracks(yield_label=True))
    cells = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a <= 0:
            continue
        mid = 0.5 * (a + b)
        # unique labels per cell (dict.fromkeys keeps first-seen order): an
        # annotation may carry the same speaker in several overlapping
        # tracks, but "r active reference speakers" counts each speaker
        # once — duplicate tracks would otherwise inflate total/miss/fa
        r = list(
            dict.fromkeys(
                lbl
                for seg, _, lbl in ref_tracks
                if seg.start <= mid < seg.end
            )
        )
        h = list(
            dict.fromkeys(
                lbl
                for seg, _, lbl in hyp_tracks
                if seg.start <= mid < seg.end
            )
        )
        if r or h:
            cells.append((b - a, r, h))
    return cells


def _cooccurrence(
    reference: Annotation, hypothesis: Annotation, cells=None
) -> Tuple[np.ndarray, List[str], List[str]]:
    ref_labels = reference.labels()
    hyp_labels = hypothesis.labels()
    matrix = np.zeros((len(ref_labels), len(hyp_labels)))
    r_idx = {l: i for i, l in enumerate(ref_labels)}
    h_idx = {l: i for i, l in enumerate(hyp_labels)}
    if cells is None:
        cells = _cells(reference, hypothesis)
    for dur, r, h in cells:
        for rl in r:
            for hl in h:
                matrix[r_idx[rl], h_idx[hl]] += dur
    return matrix, ref_labels, hyp_labels


class BaseMetric:
    """Accumulating metric with a pandas report, mirroring the surface of
    ``pyannote.metrics.base.BaseMetric`` consumed by the reference
    (``metric(ref, hyp)`` accumulation + ``metric.report()``)."""

    name = "base metric"

    def __init__(self):
        self._results: List[Tuple[str, Dict[str, float]]] = []

    @property
    def metric_name(self) -> str:
        return self.name

    def compute_components(
        self, reference: Annotation, hypothesis: Annotation, **kwargs
    ) -> Dict[str, float]:
        raise NotImplementedError

    def compute_metric(self, components: Dict[str, float]) -> float:
        raise NotImplementedError

    def __call__(
        self,
        reference: Annotation,
        hypothesis: Annotation,
        detailed: bool = False,
        **kwargs,
    ):
        components = self.compute_components(reference, hypothesis, **kwargs)
        uri = hypothesis.uri or reference.uri or f"file{len(self._results)}"
        self._results.append((uri, components))
        if detailed:
            out = dict(components)
            out[self.name] = self.compute_metric(components)
            return out
        return self.compute_metric(components)

    def __abs__(self) -> float:
        totals: Dict[str, float] = {}
        for _, comp in self._results:
            for k, v in comp.items():
                totals[k] = totals.get(k, 0.0) + v
        return self.compute_metric(totals) if totals else 0.0

    def reset(self):
        self._results = []

    def report(self, display: bool = False) -> "pd.DataFrame":
        """Per-file + TOTAL report. ``report.loc['TOTAL', (name, '%')]``
        matches the consumption pattern in diart's optimizer
        (``optim.py:122``)."""
        import pandas as pd

        rows = []
        index = []
        totals: Dict[str, float] = {}
        for uri, comp in self._results:
            index.append(uri)
            row = dict(comp)
            row[self.name] = 100.0 * self.compute_metric(comp)
            rows.append(row)
            for k, v in comp.items():
                totals[k] = totals.get(k, 0.0) + v
        total_row = dict(totals)
        total_row[self.name] = 100.0 * (self.compute_metric(totals) if totals else 0.0)
        rows.append(total_row)
        index.append("TOTAL")
        df = pd.DataFrame(rows, index=index)
        df.columns = pd.MultiIndex.from_tuples(
            [(c, "%") if c == self.name else (c, "") for c in df.columns]
        )
        if display:
            print(df.to_string())
        return df


class DiarizationErrorRate(BaseMetric):
    """DER with optimal speaker mapping.

    Parity target: ``pyannote.metrics.diarization.DiarizationErrorRate``
    with ``collar=0, skip_overlap=False`` as suggested by the reference
    diarization pipeline (``blocks/diarization.py:131-133``).
    """

    name = "diarization error rate"

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        super().__init__()
        self.collar = collar
        self.skip_overlap = skip_overlap

    def optimal_mapping(
        self, reference: Annotation, hypothesis: Annotation
    ) -> Dict[str, str]:
        """Hypothesis-label -> reference-label mapping maximizing overlap."""
        matrix, ref_labels, hyp_labels = _cooccurrence(reference, hypothesis)
        if matrix.size == 0:
            return {}
        rows, cols = linear_sum_assignment(-matrix)
        return {
            hyp_labels[c]: ref_labels[r]
            for r, c in zip(rows, cols)
            if matrix[r, c] > 0
        }

    def compute_components(
        self,
        reference: Annotation,
        hypothesis: Annotation,
        uem: Optional[Timeline] = None,
        **kwargs,
    ) -> Dict[str, float]:
        regions = _evaluation_regions(
            reference, hypothesis, uem, self.collar, self.skip_overlap
        )
        ref = _crop_to_regions(reference, regions)
        hyp = _crop_to_regions(hypothesis, regions)

        # ONE boundary scan feeds both the mapping matrix and the scoring
        # loop (the scan is the dominant cost on long files)
        cells = _cells(ref, hyp)
        matrix, ref_labels, hyp_labels = _cooccurrence(ref, hyp, cells=cells)
        mapping: Dict[str, str] = {}
        if matrix.size > 0:
            rows, cols = linear_sum_assignment(-matrix)
            mapping = {hyp_labels[c]: ref_labels[r] for r, c in zip(rows, cols)}

        total = miss = fa = conf = correct = 0.0
        for dur, r, h in cells:
            nr, nh = len(r), len(h)
            mapped = [mapping.get(hl) for hl in h]
            ncorrect = 0
            r_remaining = list(r)
            for m in mapped:
                if m in r_remaining:
                    ncorrect += 1
                    r_remaining.remove(m)
            total += dur * nr
            correct += dur * ncorrect
            miss += dur * max(0, nr - nh)
            fa += dur * max(0, nh - nr)
            conf += dur * (min(nr, nh) - ncorrect)
        return {
            "total": total,
            "correct": correct,
            "missed detection": miss,
            "false alarm": fa,
            "confusion": conf,
        }

    def compute_metric(self, components: Dict[str, float]) -> float:
        total = components.get("total", 0.0)
        error = (
            components.get("missed detection", 0.0)
            + components.get("false alarm", 0.0)
            + components.get("confusion", 0.0)
        )
        if total == 0.0:
            return 0.0 if error == 0.0 else 1.0
        return error / total


class DetectionErrorRate(BaseMetric):
    """Voice-activity detection error rate (miss + false alarm over speech).

    Parity target: ``pyannote.metrics.detection.DetectionErrorRate`` used by
    the reference VAD pipeline (``blocks/vad.py:108-110``).
    """

    name = "detection error rate"

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        super().__init__()
        self.collar = collar
        self.skip_overlap = skip_overlap

    def compute_components(
        self,
        reference: Annotation,
        hypothesis: Annotation,
        uem: Optional[Timeline] = None,
        **kwargs,
    ) -> Dict[str, float]:
        regions = _evaluation_regions(
            reference, hypothesis, uem, self.collar, self.skip_overlap
        )
        ref_speech = _crop_to_regions(reference, regions).get_timeline().support()
        hyp_speech = _crop_to_regions(hypothesis, regions).get_timeline().support()

        total = ref_speech.duration()
        # miss = ref not covered by hyp; fa = hyp not covered by ref
        miss = _timeline_minus_duration(ref_speech, hyp_speech)
        fa = _timeline_minus_duration(hyp_speech, ref_speech)
        return {"total": total, "miss": miss, "false alarm": fa}

    def compute_metric(self, components: Dict[str, float]) -> float:
        total = components.get("total", 0.0)
        error = components.get("miss", 0.0) + components.get("false alarm", 0.0)
        if total == 0.0:
            return 0.0 if error == 0.0 else 1.0
        return error / total


def _timeline_minus_duration(a: Timeline, b: Timeline) -> float:
    """Duration of ``a`` not covered by ``b`` (both must be supports)."""
    return sum(seg.duration for seg in _subtract(a, b))
