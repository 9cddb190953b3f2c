"""Frame scores -> continuous speaker turns -> RTTM text (port of
``diart_tpu/ops/binarize.py``).

A speaker turn starts at the first frame above the threshold (strictly
greater) and ends at the first frame at or below it; turn boundaries sit at
frame *middles*. Everything here is numpy on the host except
:func:`pack_binarized_bits`, which thresholds and packs on the step's
device so that the serving fetch carries one bit per (frame, speaker) cell.
The batch routes are the plain versions of the native assembler
(``native/rttm.cpp``); all routes give string-identical RTTM, in the JAX
package's float operation order.
"""

from __future__ import annotations

import sys
import types
from typing import Optional

import numpy as np
import torch

from ..core.annotation import Annotation
from ..core.segment import Segment, SlidingWindowFeature

__all__ = [
    "binarize",
    "binarize_rttm",
    "batch_binarize_rttm",
    "batch_bits_rttm",
    "pack_binarized_bits",
    "packed_stride",
]


def _transitions(data: np.ndarray, threshold: float):
    """Onset/offset frame indices of one stream's (frames, speakers) scores,
    speaker-major (so onsets and offsets pair elementwise): an inactive
    frame padded on both sides, then the +1/-1 edges of the diff."""
    num_frames, num_speakers = data.shape
    ext = np.zeros((num_frames + 2, num_speakers), np.int8)
    ext[1:-1] = data > threshold
    d = np.diff(ext.T, axis=1)
    on_spk, on_idx = np.nonzero(d == 1)
    _, off_idx = np.nonzero(d == -1)
    return on_spk, on_idx, off_idx


def _middles(scores: SlidingWindowFeature) -> np.ndarray:
    """Frame-middle timestamps, plus one for the inactive frame that closes
    open turns."""
    sw = scores.sliding_window
    return sw.start + np.arange(scores.data.shape[0] + 1) * sw.step + 0.5 * sw.duration


def binarize(
    scores: SlidingWindowFeature, threshold: float, uri: Optional[str] = None
) -> Annotation:
    """Threshold (frames, speakers) windowed scores into an annotation with
    labels ``speaker0..speakerN-1``."""
    data = np.asarray(scores.data)
    middles = _middles(scores)
    on_spk, on_idx, off_idx = _transitions(data, threshold)
    annotation = Annotation(uri=uri, modality="speech")
    for track in range(on_spk.size):
        seg = Segment(middles[on_idx[track]], middles[off_idx[track]])
        annotation[seg, track] = f"speaker{on_spk[track]}"
    return annotation


def _rttm_lines(uri, starts, ends, speakers, track0=0):
    """One stream's RTTM text, exactly as ``binarize(...).to_rttm()``:
    empty segments dropped after the track ids were assigned, lines sorted
    by (start, end, str(track))."""
    u = uri if uri else "<NA>"
    entries = [
        (starts[t], ends[t], str(track0 + t), int(speakers[t]))
        for t in range(len(starts))
        if ends[t] - starts[t] > 0
    ]
    entries.sort(key=lambda e: (e[0], e[1], e[2]))
    return "".join(
        f"SPEAKER {u} 1 {s:.3f} {e - s:.3f} <NA> <NA> speaker{k} <NA> <NA>\n"
        for s, e, _, k in entries
    )


def binarize_rttm(
    scores: SlidingWindowFeature, threshold: float, uri: Optional[str] = None
) -> str:
    """``binarize(scores, threshold, uri).to_rttm()`` without building the
    annotation."""
    middles = _middles(scores)
    on_spk, on_idx, off_idx = _transitions(np.asarray(scores.data), threshold)
    return _rttm_lines(uri, middles[on_idx], middles[off_idx], on_spk)


def batch_binarize_rttm(
    data: np.ndarray, window_starts: np.ndarray, resolution: float, threshold: float, uris
) -> list:
    """Per-stream RTTM text of a hop in one transition pass. data:
    (B, frames, speakers) scores on windows of one ``resolution``
    (= duration = step) starting at ``window_starts`` (B,)."""
    return _batch_rttm_from_active(np.asarray(data) > threshold, window_starts, resolution, uris)


def packed_stride(frames: int, speakers: int) -> int:
    """Bytes per stream of the packed (frames, speakers) binarized map."""
    return (frames * speakers + 7) // 8


def pack_binarized_bits(scores: torch.Tensor, threshold) -> torch.Tensor:
    """(B, frames, speakers) f32 scores -> (B, packed_stride) uint8 on their
    device: ``scores > threshold`` compared in the scores' f32, as numpy
    compares the fetched f32 scores with a Python float (pass a Python float:
    a cell at exactly f32(threshold) stays inactive), padded to whole bytes
    and weighted MSB first, the order of ``np.packbits``. Plain PyTorch: a
    compare, a reshape and a weighted sum."""
    b, frames, speakers = scores.shape
    nbits = frames * speakers
    stride = packed_stride(frames, speakers)
    bits = (scores > threshold).reshape(b, nbits).to(torch.int32)
    if stride * 8 != nbits:
        bits = torch.nn.functional.pad(bits, (0, stride * 8 - nbits))
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=scores.device)
    return (bits.view(b, stride, 8) * weights).sum(-1, dtype=torch.int32).to(torch.uint8)


def batch_bits_rttm(
    bits: np.ndarray, frames: int, speakers: int, window_starts: np.ndarray, resolution: float, uris
) -> list:
    """:func:`batch_binarize_rttm` over a packed bitmap fetched from the
    device (:func:`pack_binarized_bits`); the plain version of
    ``native.rttm_from_bits``."""
    flat = np.unpackbits(np.ascontiguousarray(bits), axis=1, count=frames * speakers)
    return _batch_rttm_from_active(
        flat.reshape(bits.shape[0], frames, speakers), window_starts, resolution, uris
    )


def _batch_rttm_from_active(
    active: np.ndarray, window_starts: np.ndarray, resolution: float, uris
) -> list:
    """(B, frames, speakers) boolean activity -> per-stream RTTM text."""
    b, num_frames, num_speakers = active.shape
    ext = np.zeros((b, num_frames + 2, num_speakers), np.int8)
    ext[:, 1:-1] = active
    # speaker-major within each stream, so the enumeration order is
    # binarize's per-stream track order
    d = np.diff(ext.transpose(0, 2, 1), axis=2)
    on_b, on_spk, on_idx = np.nonzero(d == 1)
    off_b, _, off_idx = np.nonzero(d == -1)
    # frame middles start_i + idx*res + 0.5*res, in binarize's operation
    # order, so the f64 values (and their %.3f renderings) are identical
    starts = window_starts[on_b] + on_idx * resolution + 0.5 * resolution
    ends = window_starts[off_b] + off_idx * resolution + 0.5 * resolution
    out = []
    lo = 0
    bounds = np.searchsorted(on_b, np.arange(1, b + 1))
    for i in range(b):
        hi = bounds[i]
        out.append(_rttm_lines(uris[i], starts[lo:hi], ends[lo:hi], on_spk[lo:hi]))
        lo = hi
    return out


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`binarize`: ``diart_tpu_torch.ops``
    exports ``binarize`` as the JAX package's ``diart_tpu.ops`` does (the
    function), and the name stays this module for its other routes."""

    def __call__(self, *args, **kwargs):
        return binarize(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
