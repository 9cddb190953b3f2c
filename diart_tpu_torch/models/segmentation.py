"""PyanNet speaker segmentation (port of ``diart_tpu/models/segmentation.py``,
multilabel head; the powerset head is not ported yet)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .lstm import BiLSTM
from .sincnet import SincNet, num_sincnet_frames

__all__ = ["PyanNet"]


class PyanNet(nn.Module):
    """SincNet -> BiLSTM -> linear x N -> per-speaker sigmoid.

    waveform (batch, 1, samples) -> activations (batch, frames, speakers)."""

    def __init__(
        self,
        num_speakers: int = 4,
        sample_rate: int = 16000,
        compute_dtype=torch.float32,
        lstm_hidden: int = 128,
        lstm_layers: int = 4,
        linear_dims: tuple = (128, 128),
    ):
        super().__init__()
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate
        self.num_linear = len(linear_dims)
        self.sincnet = SincNet(sample_rate=sample_rate, compute_dtype=compute_dtype)
        self.lstm = BiLSTM(60, lstm_hidden, lstm_layers)
        in_dim = 2 * lstm_hidden
        for i, dim in enumerate(linear_dims):
            setattr(self, f"linear{i}", nn.Linear(in_dim, dim))
            in_dim = dim
        self.classifier = nn.Linear(in_dim, num_speakers)

    @staticmethod
    def num_frames(num_samples: int) -> int:
        return num_sincnet_frames(num_samples)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        x = self.sincnet(waveform).permute(2, 0, 1)  # (frames, batch, 60)
        # the stack stays time-major through the per-frame linear layers;
        # only the K-wide output is transposed back
        x = self.lstm(x).float()
        for i in range(self.num_linear):
            x = F.leaky_relu(getattr(self, f"linear{i}")(x), 0.01)
        return torch.sigmoid(self.classifier(x)).transpose(0, 1)
