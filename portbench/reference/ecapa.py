"""ECAPA-TDNN (Desplanques et al. 2020; speechbrain's recipe): log-mel fbanks, a
TDNN stem, three SE-Res2Blocks, multi-layer aggregation, channel-attentive
statistics pooling that the speakers' frame weights re-normalize, batch
norm, a linear embedding."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import Numerics, Params, batch_norm, l2_normalize, resample

def speechbrain_mel(num_mels=80, n_fft=400, sample_rate=16000, f_min=0.0, f_max=8000.0) -> np.ndarray:
    """speechbrain's triangular mel filters, both slopes over the left
    bandwidth: (num_mels, n_fft // 2 + 1)."""
    to_mel = lambda hz: 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)
    to_hz = lambda mel: 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), num_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]
    slope = (freqs[None, :] - hz[1:-1][:, None]) / band[:, None]
    return np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))


def log_mel(wave: torch.Tensor, num: Numerics, num_mels=80, n_fft=400, hop=160, top_db=80.0) -> torch.Tensor:
    """(N, samples) -> (N, frames, mels): centred STFT with zero padding and
    a periodic Hamming window, power, mel filters, 10 log10 floored at 1e-10
    and at top_db below the window's peak, then the mean over frames taken
    out."""
    window = torch.hamming_window(n_fft, periodic=True, device=wave.device)
    spec = torch.stft(wave.float(), n_fft, hop, n_fft, window, center=True, pad_mode="constant",
                      return_complex=True)
    power = num(spec.real ** 2 + spec.imag ** 2, "fbank")
    mel = torch.as_tensor(speechbrain_mel(num_mels, n_fft), dtype=torch.float32, device=wave.device)
    db = 10.0 * torch.log10(torch.clamp(num(torch.einsum("nft,mf->ntm", power, num(mel, "fbank")), "fbank"),
                                        min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - top_db)
    return db - db.mean(dim=1, keepdim=True)


def tdnn_block(p: Params, pre: str, x: torch.Tensor, kernel: int, dilation: int, num: Numerics) -> torch.Tensor:
    """speechbrain TDNNBlock on (N, T, C): reflect-padded 'same' convolution
    with bias, ReLU, batch norm."""
    pad = (kernel - 1) * dilation // 2
    xt = x.transpose(1, 2)
    if pad:
        xt = F.pad(xt, (pad, pad), mode="reflect")
    y = F.conv1d(num(xt, "embedding"), num(p[pre + "conv.weight"], "embedding"), dilation=dilation)
    y = num(y + p[pre + "conv.bias"][None, :, None], "embedding").transpose(1, 2)
    return num(batch_norm(p, pre + "bn.", torch.relu(y), -1), "embedding")


def se_res2_block(p: Params, pre: str, x: torch.Tensor, dilation: int, num: Numerics, scale: int = 8) -> torch.Tensor:
    z1 = tdnn_block(p, pre + "tdnn1.", x, 1, 1, num)
    chunks = torch.chunk(z1, scale, dim=-1)
    outs, y = [chunks[0]], None
    for i in range(1, scale):
        y = tdnn_block(p, f"{pre}res2net.block{i - 1}.", chunks[i] if y is None else num(chunks[i] + y, "embedding"),
                       3, dilation, num)
        outs.append(y)
    z2 = tdnn_block(p, pre + "tdnn2.", torch.cat(outs, dim=-1), 1, 1, num)
    s = z2.mean(dim=1)
    s = torch.relu(s @ p[pre + "se.conv1.weight"].t() + p[pre + "se.conv1.bias"])
    gate = torch.sigmoid(s @ p[pre + "se.conv2.weight"].t() + p[pre + "se.conv2.bias"])
    return num(x + num(z2 * num(gate[:, None, :], "embedding"), "embedding"), "embedding")


def embed(p: Params, wave: torch.Tensor, weights: torch.Tensor, num: Numerics, args: dict) -> torch.Tensor:
    """(N, 1, samples), frame weights (N, K, frames) -> unit embeddings (N, K, E)."""
    feats = log_mel(wave[:, 0], num)
    x = tdnn_block(p, "stem.", feats, 5, 1, num)
    blocks = []
    for i, dilation in ((1, 2), (2, 3), (3, 4)):
        x = se_res2_block(p, f"block{i}.", x, dilation, num)
        blocks.append(x)
    frames = tdnn_block(p, "mfa.", torch.cat(blocks, dim=-1), 1, 1, num).float()
    w = resample(weights, frames.shape[1])
    gmean = frames.mean(dim=1, keepdim=True)
    gstd = torch.sqrt(torch.clamp(((frames - gmean) ** 2).mean(dim=1, keepdim=True), min=1e-12))
    hidden = frames @ p["att_local.weight"].t() + p["att_local.bias"]
    hidden = hidden + torch.cat([gmean, gstd], dim=-1) @ p["att_global.weight"].t()
    hidden = torch.tanh(batch_norm(p, "att_bn.", torch.relu(hidden), -1))
    alpha = torch.softmax(hidden @ p["att2.weight"].t() + p["att2.bias"], dim=1)  # (N, T, C)
    aw = alpha[:, None] * w[..., None]  # (N, K, T, C)
    den = torch.clamp(aw.sum(2), min=1e-12)
    mu = (aw * frames[:, None]).sum(2) / den
    var = (aw * (frames[:, None] - mu[:, :, None]) ** 2).sum(2) / den
    pooled = torch.cat([mu, torch.sqrt(torch.clamp(var, min=1e-12))], dim=-1)
    pooled = batch_norm(p, "asp_bn.", pooled, -1)
    emb = num(pooled, "embedding") @ num(p["embedding.weight"], "embedding").t() + p["embedding.bias"]
    return l2_normalize(emb)


