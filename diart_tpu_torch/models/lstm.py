"""Stacked bidirectional LSTM over a time-major sequence (port of
``diart_tpu/models/lstm.py``).

Per layer, the input projection ``x @ W_ih^T + b`` of the whole sequence is
one matrix product outside the recurrence; the recurrence itself is
:func:`diart_tpu_torch.ops.lstm_sweep.lstm_sweep_tm`, which walks direction 1
backwards by indexing, so no time-flipped copy of the gate stream is ever
made. Gate order is PyTorch's (i, f, g, o). With ``bf16_lstm`` (CUDA only)
the gate stream and the hidden states are stored in bf16. Each layer's
``w_hh`` is laid out for the sweep kernel once per stream dtype
(:func:`diart_tpu_torch.ops.lstm_sweep.pack_w_hh`) and laid out again only
when the parameter changes (``common.held_operands``).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import precision
from ..ops.lstm_sweep import lstm_sweep_tm, pack_w_hh
from .common import held_operands

__all__ = ["BiLSTM"]


class BiLSTM(nn.Module):
    """(time, batch, features) -> (time, batch, 2 * hidden).

    Parameters per layer ``i``, named as in the JAX module:
    ``l{i}_w_ih`` (2, 4H, in), ``l{i}_w_hh`` (2, 4H, H), ``l{i}_b`` (2, 4H),
    index 0 the forward direction, 1 the backward one."""

    def __init__(self, input_size: int, hidden_size: int = 128, num_layers: int = 4):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        h = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * h
            self.register_parameter(f"l{layer}_w_ih", nn.Parameter(torch.zeros(2, 4 * h, in_dim)))
            self.register_parameter(f"l{layer}_w_hh", nn.Parameter(torch.zeros(2, 4 * h, h)))
            self.register_parameter(f"l{layer}_b", nn.Parameter(torch.zeros(2, 4 * h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (T, B, F) -> (T, B, 2H), in the stream dtype."""
        stream = torch.bfloat16 if precision.enabled("bf16_lstm", x.device) else x.dtype
        time, batch, _ = x.shape
        g4 = 4 * self.hidden_size
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"l{layer}_w_ih")
            w_hh = getattr(self, f"l{layer}_w_hh")
            b = getattr(self, f"l{layer}_b")
            y = torch.matmul(x.to(stream), w_ih.to(stream).reshape(2 * g4, -1).t())
            proj = (y.view(time, batch, 2, g4).float() + b).to(stream)
            proj_t = proj.transpose(1, 2).contiguous()  # (T, 2, B, 4H)
            packed = held_operands(self, (layer, stream), [w_hh], lambda: pack_w_hh(w_hh, stream))
            out_t = lstm_sweep_tm(proj_t, w_hh if packed is None else None, operands=packed)
            x = torch.cat([out_t[:, 0], out_t[:, 1]], dim=-1)
        return x
