"""Parts the reference models share: the precision of each part (the
reference and its control), SincNet, norms and pooling."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Numerics:
    """What precision each part of the reference computes in.

    ``stated``: part -> "f32" or "bf16", as the configuration states it
    (``precision_of_parts`` in its file). Reference: float32 everywhere.
    Control (``lower``): operands and results of each part rounded one step
    below the stated precision, products summed in float32."""

    def __init__(self, stated: Dict[str, str], lower: bool = False):
        self.stated = dict(stated)
        self.lower = lower

    def __call__(self, x: torch.Tensor, part: str) -> torch.Tensor:
        x = x.float()
        if not self.lower:
            return x
        kind = self.stated[part]
        if kind == "f32":
            return x.to(torch.bfloat16).float()
        if kind == "bf16":
            scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        raise ValueError(f"unknown stated precision {kind!r} of part {part!r}")


@contextmanager
def true_f32():
    """TF32 off for products and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def instance_norm(x, scale, bias, eps=1e-5):
    """(N, C, T) normalized over T with the biased variance, then scaled."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale[None, :, None] + bias[None, :, None]


def sinc_filters(low_hz, band_hz, kernel=251, sample_rate=16000, min_low=50.0, min_band=50.0):
    """ParamSincFB band-pass filters (cosine then sine halves) from the
    learnable cutoffs: (F / 2,) x 2 -> (F, kernel)."""
    low = min_low + low_hz.float().abs()
    high = torch.clamp(low + min_band + band_hz.float().abs(), min_low, sample_rate / 2)
    band = (high - low)[:, None]
    half = kernel // 2
    n_lin = torch.linspace(0.0, kernel / 2 - 1, half, device=low.device, dtype=torch.float64)
    window = (0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel))[None, :].float()
    n = (2 * math.pi * torch.arange(-((kernel - 1) / 2.0), 0.0, device=low.device,
                                    dtype=torch.float64) / sample_rate)[None, :].float()
    f_low, f_high = low[:, None] * n, high[:, None] * n
    cos_left = (torch.sin(f_high) - torch.sin(f_low)) / (n / 2) * window
    sin_left = (torch.cos(f_low) - torch.cos(f_high)) / (n / 2) * window
    cos_f = torch.cat([cos_left, 2 * band, cos_left.flip(1)], dim=1)
    sin_f = torch.cat([sin_left, torch.zeros_like(band), -sin_left.flip(1)], dim=1)
    return torch.cat([cos_f / (2 * band), sin_f / (2 * band)], dim=0)


def sincnet(p: Params, pre: str, wave: torch.Tensor, num: Numerics, part: str) -> torch.Tensor:
    """(N, 1, samples) -> (N, 60, frames)."""
    x = instance_norm(wave.float(), p[pre + "wav_norm_scale"], p[pre + "wav_norm_bias"])
    filters = sinc_filters(p[pre + "sinc.low_hz"], p[pre + "sinc.band_hz"])
    y = F.conv1d(num(x, "sinc"), num(filters, "sinc")[:, None, :], stride=10)
    y = num(y, "frontend")  # the pre-pool activation's storage
    x = F.leaky_relu(instance_norm(F.max_pool1d(y.abs(), 3), p[pre + "norm1_scale"],
                                   p[pre + "norm1_bias"]), 0.01)
    for i in (2, 3):
        w, b = p[f"{pre}conv{i}.weight"], p[f"{pre}conv{i}.bias"]
        x = num(F.conv1d(num(x, part), num(w, part), num(b, part)), part)
        x = F.max_pool1d(x, 3)
        x = F.leaky_relu(instance_norm(x, p[f"{pre}norm{i}_scale"], p[f"{pre}norm{i}_bias"]), 0.01)
    return x




def osp_weights(seg: torch.Tensor, gamma: float = 3.0, beta: float = 10.0) -> torch.Tensor:
    """Overlapped-speech penalty: (N, frames, K) -> frame weights (N, K, frames)."""
    w = seg ** gamma * torch.softmax(beta * seg, dim=-1) ** gamma
    return torch.clamp(w, min=1e-8).transpose(1, 2)


def resample(weights: torch.Tensor, frames: int) -> torch.Tensor:
    """Nearest-neighbour weights (N, K, src) on a grid of ``frames``."""
    src = weights.shape[-1]
    idx = torch.arange(frames, device=weights.device) * src // frames
    return weights[..., idx]


def weighted_mean_std(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x (N, T, C), w (N, K, T) -> [mean, std] (N, K, 2C): the weighted mean
    and the reliability-weighted unbiased standard deviation, in two passes."""
    v1 = w.sum(-1)
    v2 = (w * w).sum(-1)
    mean = torch.einsum("ntc,nkt->nkc", x, w) / (v1 + eps)[..., None]
    dev2 = torch.einsum("ntkc,nkt->nkc", (x[:, :, None, :] - mean[:, None]) ** 2, w)
    var = torch.clamp(dev2 / (v1 - v2 / torch.clamp(v1, min=eps) + eps)[..., None], min=0.0)
    return torch.cat([mean, torch.sqrt(var)], dim=-1)


def batch_norm(p: Params, pre: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = -1
    a = p[pre + "scale"] / torch.sqrt(p[pre + "var"] + 1e-5)
    return (x - p[pre + "mean"].view(shape)) * a.view(shape) + p[pre + "bias"].view(shape)


def l2_normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


