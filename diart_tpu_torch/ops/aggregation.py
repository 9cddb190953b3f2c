"""Latency-controlled Hamming overlap-add with a static gather plan (port
of ``diart_tpu/ops/aggregation.py``).

The crop indices of the focus region inside a buffer of age ``a`` are
independent of wall time, so :func:`build_geometry` precomputes (in numpy)
the frame indices and weights for every warm-up phase, and
:func:`aggregate` reads them with one gather per stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.segment import Segment, SlidingWindow

__all__ = ["AggregationGeometry", "aggregate", "build_geometry"]


class AggregationGeometry(NamedTuple):
    """Static aggregation plan; see the JAX package's docstring. indices and
    weights are (W, W, num_out): ``[c-1, a]`` reads the buffer of age ``a``
    when ``c`` buffers are present."""

    num_windows: int
    num_out: int
    indices: np.ndarray
    weights: np.ndarray
    first_num_out: int
    first_indices: np.ndarray
    duration: float
    step: float
    latency: float

    @property
    def out_resolution(self) -> float:
        return self.step / self.num_out

    @property
    def first_resolution(self) -> float:
        return (self.duration - self.latency + self.step) / self.first_num_out


def build_geometry(
    duration: float,
    step: float,
    latency: float,
    num_frames: int,
    strategy: str = "hamming",
    cropping_mode: str = "loose",
) -> AggregationGeometry:
    """Gather indices and weights for delayed aggregation of score buffers
    on a ``duration / num_frames`` grid."""
    assert strategy in ("hamming", "mean", "first"), strategy
    num_windows = int(round(latency / step))
    res = duration / num_frames
    t_new = (num_windows - 1) * step
    focus = Segment(t_new + duration - latency, t_new + duration - latency + step)
    num_out = SlidingWindow(duration=res, step=res, start=0.0).samples(step, mode=cropping_mode)
    hamming = np.hamming(num_frames)

    indices = np.zeros((num_windows, num_windows, num_out), dtype=np.int32)
    weights = np.zeros((num_windows, num_windows, num_out), dtype=np.float32)
    for c in range(1, num_windows + 1):
        for a in range(c):  # age 0 = newest
            sw = SlidingWindow(duration=res, step=res, start=t_new - a * step)
            i, j = sw.crop_range(focus, mode=cropping_mode, fixed=step)
            idx = np.clip(np.arange(i, j), 0, num_frames - 1)
            indices[c - 1, a] = idx
            if strategy == "hamming":
                weights[c - 1, a] = hamming[idx]
            elif strategy == "mean":
                weights[c - 1, a] = 1.0
            else:
                weights[c - 1, a] = 1.0 if a == c - 1 else 0.0

    first_region = Segment(0.0, duration - latency + step)
    sw0 = SlidingWindow(duration=res, step=res, start=0.0)
    i0, j0 = sw0.crop_range(first_region, mode=cropping_mode, fixed=first_region.duration)
    first_indices = np.clip(np.arange(i0, j0), 0, num_frames - 1).astype(np.int32)
    return AggregationGeometry(
        num_windows=num_windows,
        num_out=num_out,
        indices=indices,
        weights=weights,
        first_num_out=len(first_indices),
        first_indices=first_indices,
        duration=duration,
        step=step,
        latency=latency,
    )


def aggregate(
    geometry: AggregationGeometry,
    buffers: torch.Tensor,
    count: torch.Tensor,
    plan=None,
) -> torch.Tensor:
    """Aggregate each stream's ring of buffers into its focus region.

    buffers: (B, W, frames, dims), age-ordered (index 0 = newest);
    count: (B,) int — how many buffers are valid (clamped to 1..W).
    plan: optional ``(indices, weights)`` tensors of the geometry already on
    ``buffers``' device (the engine keeps them there).
    Returns (B, num_out, dims).
    """
    if plan is None:
        plan = (
            torch.as_tensor(geometry.indices, device=buffers.device).long(),
            torch.as_tensor(geometry.weights, device=buffers.device),
        )
    indices, weights = plan
    phase = torch.clamp(count, 1, geometry.num_windows).long() - 1
    idx = indices[phase]  # (B, W, num_out)
    w = weights[phase]
    dims = buffers.shape[-1]
    gathered = torch.gather(buffers, 2, idx[..., None].expand(-1, -1, -1, dims))
    num = (w[..., None] * gathered).sum(dim=1)
    den = w.sum(dim=1)[..., None]
    return num / torch.clamp(den, min=1e-30)
