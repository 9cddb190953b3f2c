"""PyanNet speaker segmentation (port of ``diart_tpu/models/segmentation.py``):
the multilabel head (per-speaker sigmoids) and the powerset head
(log-softmax over speaker subsets, decoded by
:func:`diart_tpu_torch.models.powerset.to_multilabel` in the model
wrapper)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .lstm import BiLSTM
from .sincnet import SincNet, num_sincnet_frames

__all__ = ["PyanNet"]


class PyanNet(nn.Module):
    """SincNet -> BiLSTM -> linear x N -> per-speaker sigmoid, or with
    ``powerset_classes > 0`` log-softmax over that many powerset classes.

    waveform (batch, 1, samples) -> (batch, frames, speakers or classes)."""

    def __init__(
        self,
        num_speakers: int = 4,
        sample_rate: int = 16000,
        compute_dtype=torch.float32,
        lstm_hidden: int = 128,
        lstm_layers: int = 4,
        linear_dims: tuple = (128, 128),
        powerset_classes: int = 0,
    ):
        super().__init__()
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.lstm_hidden = lstm_hidden
        self.lstm_layers = lstm_layers
        self.linear_dims = tuple(linear_dims)
        self.powerset_classes = powerset_classes
        self.num_linear = len(linear_dims)
        self.sincnet = SincNet(sample_rate=sample_rate, compute_dtype=compute_dtype)
        self.lstm = BiLSTM(60, lstm_hidden, lstm_layers)
        in_dim = 2 * lstm_hidden
        for i, dim in enumerate(linear_dims):
            setattr(self, f"linear{i}", nn.Linear(in_dim, dim))
            in_dim = dim
        self.classifier = nn.Linear(in_dim, powerset_classes or num_speakers)

    @staticmethod
    def num_frames(num_samples: int) -> int:
        return num_sincnet_frames(num_samples)

    def forward(self, waveform: torch.Tensor, sinc_pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """waveform (batch, 1, samples) -> (batch, frames, speakers), or
        powerset log-probabilities; ``sinc_pooled``: see ``SincNet``."""
        x = self.sincnet(waveform, sinc_pooled).permute(2, 0, 1)  # (frames, batch, 60)
        # the stack stays time-major through the per-frame linear layers;
        # only the K-wide output is transposed back
        x = self.lstm(x).float()
        for i in range(self.num_linear):
            x = F.leaky_relu(getattr(self, f"linear{i}")(x), 0.01)
        logits = self.classifier(x)
        if self.powerset_classes > 0:
            return torch.log_softmax(logits, dim=-1).transpose(0, 1)
        return torch.sigmoid(logits).transpose(0, 1)
