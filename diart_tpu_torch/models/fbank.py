"""Log-mel filterbank frontend (port of the speechbrain kind of
``diart_tpu/models/fbank.py``), direct and incremental.

Framing, windowing and the DFT run as one strided convolution whose basis
(cosine rows, then sine rows, window folded in) is a numpy float64
constant cast to f32, as in the JAX package. The DFT product and the mel
contraction run in true f32 whatever the caller's TF32 flags say
(:func:`_true_f32`): TF32 keeps about three decimal digits, and the JAX
package asks for ``precision=HIGHEST`` here off the TPU.

The incremental pieces (``FbankRingSpec`` ... ``fbank_edge_right``) are
what the engine's ``fbank_ring`` uses: every stage up to the window-level
normalization is frame-local, so the raw per-frame features of the
unchanged samples live in a ring across hops and only the new block's
frames and the window-edge frames are computed each hop. The ring geometry
covers all three kinds; only the speechbrain kind's features are ported
(``ROADMAP.md`` Queue 1 item 10 queues the kaldi and nemo kinds).
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FbankRingSpec",
    "fbank_block_raw",
    "fbank_edge_left",
    "fbank_edge_right",
    "fbank_ring_fill",
    "fbank_ring_spec",
    "speechbrain_log_mel",
    "speechbrain_mel_matrix",
]

_QUEUED = "the {} fbank kind is not ported yet (ROADMAP.md Queue 1 item 10)"


@contextlib.contextmanager
def _true_f32(device: torch.device):
    """Run f32 convolutions and matrix products without TF32 on CUDA,
    restoring the caller's flags afterwards."""
    if device.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def speechbrain_mel_matrix(
    num_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> np.ndarray:
    """Triangular mel filterbank in speechbrain's convention (both slopes
    normalized by the left bandwidth, peak 1). (num_mels, n_fft // 2 + 1)."""
    all_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), num_mels + 2)
    hz = _mel_to_hz(mel)
    band = (hz[1:] - hz[:-1])[:-1]
    f_central = hz[1:-1]
    slope = (all_freqs[None, :] - f_central[:, None]) / band[:, None]
    return np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0)).astype(np.float32)


def _dft_rows(dft_size: int, taps: np.ndarray, bins: int, offset: int = 0):
    """(cos, sin) DFT basis rows ``cis(-2pi k (offset+m) / dft_size)`` at tap
    positions ``m``, times the window — float64."""
    k = np.arange(bins)[:, None].astype(np.float64)
    n = (offset + np.arange(len(taps)))[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / dft_size
    return np.cos(ang) * taps[None, :], np.sin(ang) * taps[None, :]


@lru_cache(maxsize=None)
def _hamming_basis(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n / n_fft)  # periodic Hamming
    cos_r, sin_r = _dft_rows(n_fft, window, n_fft // 2 + 1)
    return np.concatenate([cos_r, sin_r], 0).astype(np.float32)


_CONSTANTS: dict = {}


def _constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy constant as a cached f32 tensor on ``device``."""
    key = (id(array), str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return t


@lru_cache(maxsize=None)
def _phase_basis(n_fft: int, hop: int) -> np.ndarray:
    """The Hamming DFT basis as a (2 * bins, hop, ceil(n_fft / hop)) stride-1
    convolution over the waveform viewed as ``hop`` interleaved channels."""
    basis = _hamming_basis(n_fft)
    k = -(-n_fft // hop)
    w = np.pad(basis, ((0, 0), (0, k * hop - n_fft))).reshape(-1, k, hop)
    return np.ascontiguousarray(np.swapaxes(w, 1, 2))


def _dft_power(signal: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Power spectrum of hopped Hamming frames: signal (B, samples), frame
    ``t`` starting at sample ``t * hop`` -> (B, frames, n_fft // 2 + 1) f32.

    The waveform is viewed as ``hop`` interleaved channels, so the stride-hop
    single-channel convolution becomes a stride-1, hop-channel one (the JAX
    package's phase decomposition; exact)."""
    batch, samples = signal.shape
    bins = n_fft // 2 + 1
    num_frames = (samples - n_fft) // hop + 1
    k = -(-n_fft // hop)
    needed = (num_frames + k - 1) * hop
    x = signal[:, :needed].float()
    if needed > samples:
        x = F.pad(x, (0, needed - samples))
    x = x.reshape(batch, -1, hop).transpose(1, 2)  # (B, hop, hops)
    w = _constant(_phase_basis(n_fft, hop), signal.device)
    with _true_f32(signal.device):
        y = F.conv1d(x, w)  # (B, 2 * bins, frames)
    power = y[:, :bins] ** 2 + y[:, bins:] ** 2
    return power.transpose(1, 2)


def _mel_db(power: torch.Tensor, mel: np.ndarray, amin: float = 1e-10) -> torch.Tensor:
    """10 log10 of the mel energies of ``power`` (B, frames, bins), floored
    at ``amin`` — speechbrain's cached (pre top_db) stage."""
    with _true_f32(power.device):
        fb = torch.matmul(power, _constant(mel, power.device).t())
    return 10.0 * torch.log10(torch.clamp(fb, min=amin))


def speechbrain_log_mel(
    waveform: torch.Tensor,
    num_mels: int = 80,
    n_fft: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float = 8000.0,
    amin: float = 1e-10,
    top_db: float = 80.0,
) -> torch.Tensor:
    """(B, samples) -> (B, frames, num_mels) log-mel fbanks in speechbrain's
    ``Fbank`` convention: centered STFT with zero padding and a periodic
    Hamming window, power spectrum, speechbrain mel triangles, 10 log10 with
    a per-utterance top_db floor."""
    samples = waveform.shape[1]
    pad = n_fft // 2
    padded = F.pad(waveform.float(), (pad, pad))
    num_frames = samples // hop + 1
    need = (num_frames - 1) * hop + n_fft
    power = _dft_power(padded[:, :need], n_fft, hop)
    x_db = _mel_db(power, speechbrain_mel_matrix(num_mels, n_fft, sample_rate, f_min, f_max), amin)
    floor = x_db.amax(dim=(1, 2), keepdim=True) - top_db
    return torch.maximum(x_db, floor)


# --------------------------------------------------------------------- #
# Incremental (ring) frontend
# --------------------------------------------------------------------- #
class FbankRingSpec(NamedTuple):
    """Geometry of one mel frontend's incremental frame ring."""

    kind: str  # "kaldi" | "speechbrain" | "nemo"
    num_mels: int
    sample_rate: int
    hop: int
    win: int  # conv taps per frame (frame span in samples)
    pad: int  # centered-framing margin (win // 2), 0 for snip-edges
    preemph: float  # whole-signal pre-emphasis (nemo), else 0
    frames: int  # window frames T_w
    fpb: int  # ring frames ingested per block
    nb: int  # blocks per window
    trim: int  # chronological ring frames dropped at read
    interior: int  # frames served from the ring
    edge: int  # left-edge frames recomputed at read (= right-edge count)
    tail_conv: int  # previous-block samples the block conv needs
    right_need: int  # newest raw samples the right-edge frames need
    head_len: int  # per-block stored window-start samples (0 if edge == 0)
    tail_len: int  # per-stream stored newest raw samples


_FBANK_KINDS = {
    # kind: (win, hop, pad, preemph)
    "kaldi": (400, 160, 0, 0.0),
    "speechbrain": (400, 160, 200, 0.0),
    "nemo": (400, 160, 200, 0.97),
}


def fbank_ring_spec(
    kind: str, num_mels: int, sample_rate: int, chunk_samples: int, step_samples: int
) -> Optional[FbankRingSpec]:
    """The ring geometry, or None when the incremental decomposition does
    not apply (the hop grid does not divide the step, or the edge context
    spans more than one block)."""
    if kind not in _FBANK_KINDS:
        return None
    win, hop, pad, preemph = _FBANK_KINDS[kind]
    if step_samples % hop or chunk_samples % step_samples:
        return None
    if win - hop > step_samples or chunk_samples <= win:
        return None
    frames = chunk_samples // hop + 1 if pad else (chunk_samples - win) // hop + 1
    fpb = step_samples // hop
    nb = chunk_samples // step_samples
    # global frame-start grid: A = -pad (mod hop); block k ingests the
    # frames whose sample span completes inside block k
    anchor = (-pad) % hop
    base = -win
    a_min = base + 1 + ((anchor - (base + 1)) % hop)
    tail_conv = -a_min
    edge = -(-pad // hop)
    e_r = (frames - 1) - (chunk_samples + pad - win) // hop if pad else 0
    assert e_r == edge, (e_r, edge)
    interior = frames - 2 * edge
    trim = (edge * hop - pad + tail_conv) // hop
    assert 0 <= trim and trim + interior <= nb * fpb
    right_need = chunk_samples - ((frames - edge) * hop - pad) if edge else 0
    head_len = ((edge - 1) * hop - pad + win) if edge else 0
    ctx = 1 if preemph else 0
    tail_len = max(tail_conv + ctx, right_need + ctx, 1)
    if head_len > step_samples or tail_len > step_samples:
        return None
    if edge and preemph and (right_need < pad + 1 or head_len < pad + 1):
        return None
    return FbankRingSpec(
        kind=kind, num_mels=num_mels, sample_rate=sample_rate, hop=hop, win=win,
        pad=pad, preemph=preemph, frames=frames, fpb=fpb, nb=nb, trim=trim,
        interior=interior, edge=edge, tail_conv=tail_conv, right_need=right_need,
        head_len=head_len, tail_len=tail_len,
    )


def _fbank_raw_frames(spec: FbankRingSpec, x: torch.Tensor) -> torch.Tensor:
    """Cached-stage features of the frames starting on x's sample-0 grid:
    (B, samples) -> (B, (samples - win) // hop + 1, num_mels). The constants
    are the direct frontend's defaults, as the model calls it."""
    if spec.kind != "speechbrain":
        raise NotImplementedError(_QUEUED.format(spec.kind))
    power = _dft_power(x, spec.win, spec.hop)
    return _mel_db(power, speechbrain_mel_matrix(spec.num_mels, spec.win, spec.sample_rate))


def fbank_ring_fill(spec: FbankRingSpec) -> np.ndarray:
    """The cached-stage value of a frame of all-zero samples — what a
    never-written ring slot holds, so warm-up windows reproduce the direct
    path's zero-filled window. (num_mels,) float32."""
    if spec.kind != "speechbrain":
        raise NotImplementedError(_QUEUED.format(spec.kind))
    return np.full(spec.num_mels, -100.0, np.float32)  # 10 log10(1e-10)


def fbank_block_raw(spec: FbankRingSpec, tail: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Cached-stage features of the ``fpb`` frames a new block completes.
    tail: (B, >= tail_conv) raw samples before the block; block:
    (B, step_samples) -> (B, fpb, num_mels)."""
    if spec.preemph:
        raise NotImplementedError(_QUEUED.format(spec.kind))
    x = torch.cat([tail[:, tail.shape[1] - spec.tail_conv :], block], dim=1)
    return _fbank_raw_frames(spec, x)[:, : spec.fpb]


def fbank_edge_left(spec: FbankRingSpec, head: torch.Tensor) -> torch.Tensor:
    """The ``edge`` window-leading frames, which read the zero left padding.
    head: (B, head_len) samples from the window start -> (B, edge, num_mels)."""
    assert spec.edge
    if spec.preemph:
        raise NotImplementedError(_QUEUED.format(spec.kind))
    return _fbank_raw_frames(spec, F.pad(head, (spec.pad, 0)))[:, : spec.edge]


def fbank_edge_right(spec: FbankRingSpec, tail: torch.Tensor) -> torch.Tensor:
    """The ``edge`` window-trailing frames, which read the zero right
    padding. tail: (B, >= right_need) newest samples -> (B, edge, num_mels)."""
    assert spec.edge
    if spec.preemph:
        raise NotImplementedError(_QUEUED.format(spec.kind))
    t = tail[:, tail.shape[1] - spec.right_need :]
    return _fbank_raw_frames(spec, F.pad(t, (0, spec.pad)))[:, : spec.edge]
