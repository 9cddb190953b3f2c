"""Plain reference of the served diarization path, for the check that decides
``correct``.

Plain PyTorch and NumPy only: nothing here imports the port, JAX or the
JAX package, and nothing takes what the port derived from the weights
(packed or folded operands, frame rings, clustering state). It works from
the raw weights and the raw audio that the benchmark made and hands to both
sides.

It follows the published descriptions the port implements:

* PyanNet segmentation (pyannote.audio): SincNet (Ravanelli & Bengio 2018,
  asteroid's ParamSincFB), a 4-layer BiLSTM, two leaky-ReLU linear layers
  and per-speaker sigmoids.
* The SincNet x-vector (Snyder et al. 2018; pyannote's XVectorSincNet):
  TDNN 512 x 4 / 1500 with leaky ReLU and batch norm, weighted mean and
  standard deviation pooling, a linear embedding.
* ECAPA-TDNN (Desplanques et al. 2020; speechbrain's recipe): log-mel
  fbanks, a TDNN stem, three SE-Res2Blocks, multi-layer aggregation,
  channel-attentive statistics pooling whose attention the speakers' frame
  weights re-normalize, batch norm, a linear embedding.
* diart's online pipeline (Coria et al. 2021): the overlapped-speech
  penalty, incremental clustering with optimal assignment, latency-delayed
  aggregation, binarization and RTTM text.

Departures, stated: batch norm is its inference form (running statistics
as parameters); the statistics are taken in two passes (the port takes raw
moments); the log-mel spectrum comes from ``torch.stft`` (the port
convolves a DFT basis). Aggregation covers ``latency == step`` only (one
buffer), the geometry of every configuration here.

Each model lives in a module of its own (``pyannet``, ``xvector``,
``ecapa``), which a configuration names. ``Numerics(lower=False)``
computes everything in float32 with TF32 off; ``Numerics(lower=True)`` is
the control: each part one precision step below what the configuration
states (float32 parts in bfloat16, bfloat16 parts in fp8 e4m3 with a
per-tensor scale).
"""

from __future__ import annotations

import importlib
from typing import Tuple

import numpy as np
import torch

from .common import Numerics, Params, osp_weights, true_f32


def model(name: str):
    """The reference model module ``portbench/reference/<name>.py``: a
    segmentation module has ``segment(params, wave, num, args)``, an
    embedding module ``embed(params, wave, weights, num, args)``."""
    return importlib.import_module(f"{__name__}.{name}")


@torch.no_grad()
def frame_scores(config: dict, seg_p: Params, emb_p: Params, waves: torch.Tensor, num: Numerics,
                 block: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Segmentation (N, frames, K) and unit embeddings (N, K, E) of N windows
    (N, samples) under ``config``'s models, float64 on the host, computed in
    blocks of ``block`` windows."""
    seg_cfg, emb_cfg, hyper = config["segmentation"], config["embedding"], config["engine"]
    segment = model(seg_cfg["reference"]).segment
    embed = model(emb_cfg["reference"]).embed
    segs, embs = [], []
    with true_f32():
        for lo in range(0, waves.shape[0], block):
            wave = waves[lo:lo + block, None, :].float()
            seg = segment(seg_p, wave, num, seg_cfg["args"])
            emb = embed(emb_p, wave, osp_weights(seg, hyper["gamma"], hyper["beta"]), num, emb_cfg["args"])
            segs.append(seg.double().cpu().numpy())
            embs.append(emb.double().cpu().numpy())
    return np.concatenate(segs), np.concatenate(embs)


