"""The SincNet x-vector (Snyder et al. 2018; pyannote's XVectorSincNet): TDNN
512 x 4 / 1500, weighted mean and standard deviation pooling, a linear
embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Numerics, Params, batch_norm, l2_normalize, resample, sincnet, weighted_mean_std

XVECTOR_TDNN = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))  # (kernel, dilation) of tdnn0..4


def embed(p: Params, wave: torch.Tensor, weights: torch.Tensor, num: Numerics, args: dict) -> torch.Tensor:
    """(N, 1, samples), frame weights (N, K, frames) -> unit embeddings (N, K, E)."""
    x = sincnet(p, "sincnet.", wave, num, "embedding")
    for i, (_, dilation) in enumerate(XVECTOR_TDNN):
        w, b = p[f"tdnn{i}.weight"], p[f"tdnn{i}.bias"]
        x = num(F.conv1d(num(x, "embedding"), num(w, "embedding"), dilation=dilation) + b[None, :, None],
                "embedding")
        x = batch_norm(p, f"tdnn{i}_norm.", F.leaky_relu(x, 0.01), 1)
    frames = x.transpose(1, 2)
    stats = weighted_mean_std(frames, resample(weights, frames.shape[1]))
    emb = num(stats, "embedding") @ num(p["embedding.weight"], "embedding").t() + p["embedding.bias"]
    return l2_normalize(emb)


