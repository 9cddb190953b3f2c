"""PyanNet segmentation (pyannote.audio): SincNet, a stacked BiLSTM, leaky-ReLU
linear layers, per-speaker sigmoids."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Numerics, Params, sincnet


def bilstm(p: Params, pre: str, x: torch.Tensor, layers: int, num: Numerics) -> torch.Tensor:
    """(T, N, F) -> (T, N, 2H). Gate order (i, f, g, o); direction 1 walks
    time backwards."""
    time = x.shape[0]
    for layer in range(layers):
        w_ih, w_hh = p[f"{pre}l{layer}_w_ih"], p[f"{pre}l{layer}_w_hh"]
        b = p[f"{pre}l{layer}_b"]
        hidden = w_hh.shape[-1]
        proj = torch.einsum("tnf,dgf->tdng", num(x, "lstm"), num(w_ih, "lstm"))
        proj = num(proj + b[None, :, None, :], "lstm")  # (T, 2, N, 4H): the gate stream
        w = num(w_hh, "lstm").transpose(1, 2)  # (2, H, 4H)
        h = torch.zeros(2, x.shape[1], hidden, device=x.device)
        c = torch.zeros_like(h)
        out = torch.empty(time, 2, x.shape[1], hidden, device=x.device)
        for t in range(time):
            gates = torch.stack([proj[t, 0], proj[time - 1 - t, 1]]) + torch.bmm(num(h, "lstm"), w)
            i, f, g, o = gates.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t, 0] = h[0]
            out[time - 1 - t, 1] = h[1]
        x = num(torch.cat([out[:, 0], out[:, 1]], dim=-1), "lstm")
    return x


def segment(p: Params, wave: torch.Tensor, num: Numerics, args: dict) -> torch.Tensor:
    """(N, 1, samples) -> per-speaker activations (N, frames, speakers)."""
    layers, linear = args["lstm_layers"], len(args["linear_dims"])
    x = sincnet(p, "sincnet.", wave, num, "segmentation").permute(2, 0, 1)
    x = bilstm(p, "lstm.", x, layers, num)
    for i in range(linear):
        w, b = p[f"linear{i}.weight"], p[f"linear{i}.bias"]
        x = F.leaky_relu(num(num(x, "segmentation") @ num(w, "segmentation").t() + b, "segmentation"), 0.01)
    logits = num(x, "segmentation") @ num(p["classifier.weight"], "segmentation").t() + p["classifier.bias"]
    return torch.sigmoid(logits).transpose(0, 1)


