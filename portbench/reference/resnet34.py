"""The WeSpeaker ResNet34 speaker embedding (Wang et al. 2023, arXiv:2210.17016;
the ``pyannote/wespeaker-voxceleb-resnet34-LM`` checkpoint of pyannote's 3.1
pipeline): kaldi fbanks with the mean over frames taken out, a 2-D ResNet34
of BasicBlocks over the (frequency, time) plane, temporal statistics pooling
(TSTP) of the flattened (channels x frequency) maps, a linear embedding.

The fbank follows kaldi's conventions as ``torchaudio.compliance.kaldi.fbank``
computes them with dither 0: 25 ms frames every 10 ms with snipped edges,
each frame's DC removed, pre-emphasis 0.97 (the first sample against
itself), a Povey window, the power spectrum of a 512-point FFT
(``torch.fft.rfft``), kaldi's mel triangles (20 Hz to Nyquist, in
1127 ln(1 + f / 700)) and ``log(max(mel, eps))`` with the float32 epsilon.

The trunk is wespeaker's ``ResNet``: a 3x3 stem, stages of BasicBlocks
(3x3 conv, batch norm, ReLU, 3x3 conv, batch norm, a 1x1 strided conv and
batch norm on the residual where the shape changes, the add, ReLU), stride
2 entering every stage after the first, on wespeaker's (batch, 1, mel,
time) input.

Departures, stated:

* The weights are the served model's state dict, whose 2-D kernels are laid
  out (out, in, time, mel); they are transposed here onto wespeaker's
  (mel, time) plane, which gives the same maps (3x3 kernels, stride 2 and
  padding 1 alike on both axes).
* Batch norm is its inference form (running statistics as parameters).
* The waveform enters the fbank as served, in [-1, 1]: pyannote's wrapper
  scales it by 2^15 first, which after the mean over frames is taken out
  changes only frames whose mel energy lies under the epsilon floor.
* The pooling is weighted by the speakers' frame weights (nearest-neighbour
  resampled to the trunk's frames): the reliability-weighted mean and
  unbiased standard deviation, in two passes, with wespeaker's 1e-7 under
  the root; uniform weights give wespeaker's TSTP. A speaker whose weights
  are all zero pools to a zero mean and the root of 1e-7, as the served
  model's guards give.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import Numerics, Params, batch_norm, l2_normalize, resample

F32_EPS = float(np.finfo(np.float32).eps)


def kaldi_mel(num_mels: int = 80, padded: int = 512, sample_rate: int = 16000, low_freq: float = 20.0) -> np.ndarray:
    """kaldi's mel triangles over the FFT bins, the Nyquist bin's column
    zero: (num_mels, padded // 2 + 1)."""
    to_mel = lambda hz: 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)
    bins = padded // 2
    mel = to_mel(np.arange(bins) * sample_rate / padded)[None, :]
    lo, hi = to_mel(low_freq), to_mel(sample_rate / 2)
    delta = (hi - lo) / (num_mels + 1)
    left = lo + np.arange(num_mels)[:, None] * delta
    up = (mel - left) / delta
    down = (left + 2 * delta - mel) / delta
    return np.pad(np.maximum(0.0, np.minimum(up, down)), ((0, 0), (0, 1)))


def kaldi_fbank(wave: torch.Tensor, num: Numerics, num_mels: int = 80, frame: int = 400, hop: int = 160,
                sample_rate: int = 16000, preemph: float = 0.97) -> torch.Tensor:
    """(N, samples) -> (N, frames, mels) log-mel fbanks, kaldi's conventions."""
    frames = wave.float().unfold(1, frame, hop)  # (N, T, frame): whole frames only
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - preemph * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    n = torch.arange(frame, device=wave.device, dtype=torch.float64)
    povey = ((0.5 - 0.5 * torch.cos(2 * math.pi * n / (frame - 1))) ** 0.85).float()
    padded = 1 << (frame - 1).bit_length()
    spec = torch.fft.rfft(frames * povey, n=padded)
    power = num(spec.real ** 2 + spec.imag ** 2, "fbank")
    mel = torch.as_tensor(kaldi_mel(num_mels, padded, sample_rate), dtype=torch.float32, device=wave.device)
    energies = num(torch.einsum("ntf,mf->ntm", power, num(mel, "fbank")), "fbank")
    return torch.log(torch.clamp(energies, min=F32_EPS))


def conv_bn(p: Params, conv: str, bn: str, x: torch.Tensor, stride: int, pad: int, num: Numerics) -> torch.Tensor:
    """A bias-free 2-D convolution on the (mel, time) plane, then batch norm."""
    w = p[conv + ".weight"].transpose(2, 3)  # (out, in, time, mel) -> (out, in, mel, time)
    y = num(F.conv2d(num(x, "embedding"), num(w, "embedding"), stride=stride, padding=pad), "embedding")
    return num(batch_norm(p, bn + ".", y, 1), "embedding")


def basic_block(p: Params, pre: str, x: torch.Tensor, features: int, stride: int, num: Numerics) -> torch.Tensor:
    y = torch.relu(conv_bn(p, pre + "conv1", pre + "bn1", x, stride, 1, num))
    y = conv_bn(p, pre + "conv2", pre + "bn2", y, 1, 1, num)
    if stride != 1 or x.shape[1] != features:
        x = conv_bn(p, pre + "downsample_conv", pre + "downsample_bn", x, stride, 0, num)
    return torch.relu(num(y + x, "embedding"))


def trunk(p: Params, feats: torch.Tensor, num: Numerics, args: dict) -> torch.Tensor:
    """(N, frames, mels) normalized fbanks -> (N, frames', channels x mels'),
    each frame's maps flattened channel by channel."""
    x = feats.transpose(1, 2)[:, None]  # (N, 1, mel, time)
    x = torch.relu(conv_bn(p, "conv1", "bn1", x, 1, 1, num))
    c = args["base_channels"]
    for stage, depth in enumerate(args["depths"]):
        for i in range(depth):
            x = basic_block(p, f"layer{stage + 1}_{i}.", x, c * 2 ** stage, 2 if stage and not i else 1, num)
    n, ch, mels, t = x.shape
    return x.reshape(n, ch * mels, t).transpose(1, 2)


def weighted_tstp(frames: torch.Tensor, w: torch.Tensor, num: Numerics) -> torch.Tensor:
    """frames (N, T, D), w (N, K, T) -> [mean, std] (N, K, 2D): the weighted
    mean, then the reliability-weighted unbiased variance about it, 1e-7
    under the root."""
    frames, w = num(frames, "head"), num(w, "head")
    v1 = w.sum(-1)
    v2 = (w * w).sum(-1)
    mean = torch.einsum("ntd,nkt->nkd", frames, w) / torch.clamp(v1, min=1e-8)[..., None]
    dev2 = torch.einsum("nktd,nkt->nkd", (frames[:, None] - mean[:, :, None]) ** 2, w)
    var = dev2 / torch.clamp(v1 - v2 / torch.clamp(v1, min=1e-8), min=1e-8)[..., None]
    return torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1)


def embed(p: Params, wave: torch.Tensor, weights: torch.Tensor, num: Numerics, args: dict) -> torch.Tensor:
    """(N, 1, samples), frame weights (N, K, frames) -> unit embeddings (N, K, E)."""
    feats = kaldi_fbank(wave[:, 0], num, args["num_mels"])
    frames = trunk(p, feats - feats.mean(dim=1, keepdim=True), num, args)
    stats = weighted_tstp(frames, resample(weights, frames.shape[1]), num)
    emb = num(stats, "head") @ num(p["embedding.weight"], "head").t() + p["embedding.bias"]
    return l2_normalize(emb)
