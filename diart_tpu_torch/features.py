"""Polymorphic temporal feature formatting (port of
``diart_tpu/features.py``).

Blocks accept ``SlidingWindowFeature`` / numpy / torch containers
interchangeably: the formatter casts to a batched float32 tensor and
restores the caller's container on output (remembering the start time of
windowed features). A tensor stays on its device, so a CUDA tensor makes no
host round trip; a restored tensor goes back to the device its input came
from, and the host containers (numpy, ``SlidingWindowFeature``) are fetched
once. Each container kind is a small state object
(``TemporalFeatureFormatterState``), mirroring diart's public surface
(``features.py:38-75``). The JAX package's ``DeviceArrayFormatterState``
(jax arrays) has no counterpart.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Union

import numpy as np
import torch

from .core.segment import SlidingWindow, SlidingWindowFeature

TemporalFeatures = Union[SlidingWindowFeature, np.ndarray, torch.Tensor]

__all__ = [
    "TemporalFeatures",
    "TemporalFeatureFormatter",
    "TemporalFeatureFormatterState",
    "SlidingWindowFeatureFormatterState",
    "NumpyArrayFormatterState",
    "TorchTensorFormatterState",
]


class TemporalFeatureFormatterState(ABC):
    """Remembers one input container kind and restores it on output."""

    @abstractmethod
    def restore(self, features: torch.Tensor) -> TemporalFeatures:
        ...


class SlidingWindowFeatureFormatterState(TemporalFeatureFormatterState):
    def __init__(self, start_time: float, duration: float):
        self.start_time = start_time
        self.duration = duration  # total covered duration, seconds

    def restore(self, features: torch.Tensor) -> TemporalFeatures:
        batch, num_frames, _ = features.shape
        assert batch == 1, "batched SlidingWindowFeature is not supported"
        resolution = self.duration / num_frames
        window = SlidingWindow(start=self.start_time, duration=resolution, step=resolution)
        return SlidingWindowFeature(features[0].cpu().numpy(), window)


class NumpyArrayFormatterState(TemporalFeatureFormatterState):
    def restore(self, features: torch.Tensor) -> TemporalFeatures:
        return features.cpu().numpy()


class TorchTensorFormatterState(TemporalFeatureFormatterState):
    def __init__(self, device: torch.device):
        self.device = device

    def restore(self, features: torch.Tensor) -> TemporalFeatures:
        return features.to(self.device)


class TemporalFeatureFormatter:
    """Casts temporal features to (batch, frames, dims) float32 tensors and
    restores the input container type on the way out."""

    def __init__(self):
        self._state: Optional[TemporalFeatureFormatterState] = None

    def cast(self, features: TemporalFeatures) -> torch.Tensor:
        if isinstance(features, SlidingWindowFeature):
            sw = features.sliding_window
            assert sw.duration == sw.step, (
                "features sliding window duration and step must be equal"
            )
            self._state = SlidingWindowFeatureFormatterState(
                sw.start, features.data.shape[0] * sw.duration
            )
            data = torch.from_numpy(np.asarray(features.data, np.float32))
        elif isinstance(features, np.ndarray):
            self._state = NumpyArrayFormatterState()
            data = torch.from_numpy(np.asarray(features, np.float32))
        elif isinstance(features, torch.Tensor):
            self._state = TorchTensorFormatterState(features.device)
            data = features.detach().float()
        else:
            raise TypeError(
                f"temporal features must be a SlidingWindowFeature, a numpy array or a "
                f"torch tensor; got {type(features).__name__}"
            )
        assert data.dim() in (2, 3), "temporal features must be 2D or 3D"
        if data.dim() == 2:
            data = data[None]
        return data

    def restore_type(self, features: torch.Tensor) -> TemporalFeatures:
        assert self._state is not None, "cast() must be called before restore_type()"
        return self._state.restore(features)
