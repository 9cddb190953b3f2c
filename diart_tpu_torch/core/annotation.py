"""Speaker annotations, timelines and RTTM input/output.

A copy of ``diart_tpu/core/annotation.py``: the subset of
``pyannote.core.Annotation`` / ``Timeline`` behaviour the streaming stack
uses (track assignment, ``update``, ``support(collar)``, ``extrude``,
label renaming, RTTM serialization), with the same sort order and the same
``%.3f`` rendering, so RTTM text is string-identical to the JAX package's.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

from .segment import Segment

__all__ = ["Timeline", "Annotation", "load_rttm", "write_rttm"]


class Timeline:
    """An ordered set of segments (possibly overlapping)."""

    def __init__(self, segments: Optional[Iterable[Segment]] = None, uri: Optional[str] = None):
        self.uri = uri
        self._segments: List[Segment] = sorted(s for s in (segments or []) if s)

    def add(self, segment: Segment) -> "Timeline":
        if segment:
            self._segments.append(segment)
            self._segments.sort()
        return self

    def __iter__(self) -> Iterator[Segment]:
        return iter(self._segments)

    def __len__(self) -> int:
        return len(self._segments)

    def __bool__(self) -> bool:
        return len(self._segments) > 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Timeline) and self._segments == other._segments

    def extent(self) -> Segment:
        if not self._segments:
            return Segment(0.0, 0.0)
        return Segment(
            min(s.start for s in self._segments), max(s.end for s in self._segments)
        )

    def duration(self) -> float:
        """Total duration of the *support* (overlaps counted once)."""
        return sum((seg.duration for seg in self.support()), 0.0)

    def support(self, collar: float = 0.0) -> "Timeline":
        """Merge overlapping/touching segments, and segments separated by a
        gap STRICTLY smaller than ``collar`` (pyannote.core's support_iter:
        a gap of exactly ``collar`` stays split)."""
        merged: List[Segment] = []
        for seg in self._segments:
            if merged:
                gap = seg.start - merged[-1].end
                if gap <= 0 or gap < collar:
                    last = merged[-1]
                    merged[-1] = Segment(last.start, max(last.end, seg.end))
                    continue
            merged.append(seg)
        out = Timeline(uri=self.uri)
        out._segments = merged
        return out

    def union(self, other: "Timeline") -> "Timeline":
        return Timeline(list(self._segments) + list(other._segments), uri=self.uri)

    def crop(self, focus: Segment) -> "Timeline":
        out = Timeline(uri=self.uri)
        for seg in self._segments:
            inter = seg & focus
            if inter:
                out.add(inter)
        return out

    def gaps(self, support: Optional[Segment] = None) -> "Timeline":
        # `is None`, not truthiness: an empty segment passed explicitly
        # yields no gaps, not the gaps of the whole extent
        support = self.extent() if support is None else support
        out = Timeline(uri=self.uri)
        t = support.start
        for seg in self.support():
            if seg.start > t:
                out.add(Segment(t, min(seg.start, support.end)))
            t = max(t, seg.end)
            if t >= support.end:
                break
        if t < support.end:
            out.add(Segment(t, support.end))
        return out

    def to_annotation(self, labels: Union[str, Iterable[str]] = "speech") -> "Annotation":
        """Convert to an annotation; ``labels`` is one repeated label or an
        iterable yielding one label per segment."""
        ann = Annotation(uri=self.uri)
        it = None if isinstance(labels, str) else iter(labels)
        for i, seg in enumerate(self._segments):
            ann[seg, i] = labels if it is None else next(it)
        return ann


class Annotation:
    """A set of labeled tracks: ``(segment, track) -> label``."""

    def __init__(self, uri: Optional[str] = None, modality: Optional[str] = None):
        self.uri = uri
        self.modality = modality
        # insertion-ordered mapping from (segment, track) to label
        self._tracks: Dict[Tuple[Segment, Union[str, int]], str] = {}

    def __setitem__(self, key, label: str):
        segment, track = key if isinstance(key, tuple) else (key, "_")
        if segment:
            self._tracks[(segment, track)] = label

    def __len__(self) -> int:
        return len(self._tracks)

    def __bool__(self) -> bool:
        return len(self._tracks) > 0

    def itertracks(self, yield_label: bool = False) -> Iterator[tuple]:
        items = sorted(self._tracks.items(), key=lambda kv: (kv[0][0], str(kv[0][1])))
        for (segment, track), label in items:
            yield (segment, track, label) if yield_label else (segment, track)

    def itersegments(self) -> Iterator[Segment]:
        for segment, _ in self.itertracks():
            yield segment

    def labels(self) -> List[str]:
        return sorted(set(self._tracks.values()))

    def label_timeline(self, label: str) -> Timeline:
        return Timeline(
            [seg for (seg, _), lbl in self._tracks.items() if lbl == label], uri=self.uri
        )

    def get_timeline(self, copy: bool = True) -> Timeline:
        return Timeline([seg for seg, _ in self._tracks.keys()], uri=self.uri)

    def update(self, other: "Annotation") -> "Annotation":
        """Add (and overwrite) all tracks from ``other`` in place."""
        self._tracks.update(other._tracks)
        return self

    def support(self, collar: float = 0.0) -> "Annotation":
        """Merge same-label segments closer than ``collar``; one track per
        merged segment (as ``pyannote.core.Annotation.support``)."""
        out = Annotation(uri=self.uri, modality=self.modality)
        track_id = 0
        for label in self.labels():
            for seg in self.label_timeline(label).support(collar):
                out[seg, track_id] = label
                track_id += 1
        return out

    def extrude(self, removed: Segment) -> "Annotation":
        """Remove a time region from every track (crops segments)."""
        out = Annotation(uri=self.uri, modality=self.modality)
        for segment, track, label in self.itertracks(yield_label=True):
            if not segment.intersects(removed):
                out[segment, track] = label
                continue
            left = Segment(segment.start, min(segment.end, removed.start))
            right = Segment(max(segment.start, removed.end), segment.end)
            if left:
                out[left, track] = label
            if right:
                out[right, (track, "r") if not isinstance(track, int) else track] = label
        return out

    def crop(self, focus: Segment) -> "Annotation":
        out = Annotation(uri=self.uri, modality=self.modality)
        for segment, track, label in self.itertracks(yield_label=True):
            inter = segment & focus
            if inter:
                out[inter, track] = label
        return out

    def rename_labels(self, mapping: Dict[str, str], copy: bool = True) -> "Annotation":
        target = Annotation(uri=self.uri, modality=self.modality) if copy else self
        items = list(self._tracks.items())
        target._tracks = {key: mapping.get(label, label) for key, label in items}
        return target

    def shift(self, offset: float) -> "Annotation":
        """A copy with every segment shifted by ``offset`` seconds."""
        out = Annotation(uri=self.uri, modality=self.modality)
        for segment, track, label in self.itertracks(yield_label=True):
            out[Segment(segment.start + offset, segment.end + offset), track] = label
        return out

    def chart(self) -> List[Tuple[str, float]]:
        """Labels sorted by decreasing total duration."""
        durations: Dict[str, float] = {}
        for segment, _, label in self.itertracks(yield_label=True):
            durations[label] = durations.get(label, 0.0) + segment.duration
        return sorted(durations.items(), key=lambda kv: kv[1], reverse=True)

    def write_rttm(self, file) -> None:
        uri = self.uri if self.uri else "<NA>"
        for segment, _, label in self.itertracks(yield_label=True):
            file.write(
                f"SPEAKER {uri} 1 {segment.start:.3f} {segment.duration:.3f} "
                f"<NA> <NA> {label} <NA> <NA>\n"
            )

    def to_rttm(self) -> str:
        buf = io.StringIO()
        self.write_rttm(buf)
        return buf.getvalue()

    def __str__(self) -> str:
        return "\n".join(
            f"{seg} {track} {label}" for seg, track, label in self.itertracks(yield_label=True)
        )


def load_rttm(path: Union[str, Path]) -> Dict[str, Annotation]:
    """Parse an RTTM file into one annotation per URI (insertion-ordered)."""
    annotations: Dict[str, Annotation] = {}
    counters: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            uri, start, dur, label = parts[1], float(parts[3]), float(parts[4]), parts[7]
            if uri not in annotations:
                annotations[uri] = Annotation(uri=uri)
                counters[uri] = 0
            annotations[uri][Segment(start, start + dur), counters[uri]] = label
            counters[uri] += 1
    return annotations


def write_rttm(annotation: Annotation, path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        annotation.write_rttm(f)
