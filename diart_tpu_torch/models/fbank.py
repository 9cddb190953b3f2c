"""Log-mel filterbank frontends (port of ``diart_tpu/models/fbank.py``):
the generic one (:func:`log_mel_filterbank`: Hann window, floor-bin mel
triangles, ``log(mel + eps)``) and the speechbrain, kaldi and nemo kinds,
direct and incremental.

Framing, windowing and the DFT run as one strided convolution whose basis
(cosine rows, then sine rows, with the window and any per-frame linear map
such as kaldi's DC removal and pre-emphasis folded in) is a numpy float64
constant cast to f32, as in the JAX package. The DFT product and the mel
contraction run in true f32 whatever the caller's TF32 flags say
(``ops/_numerics.py`` :func:`true_f32`): TF32 keeps about three decimal
digits, and the JAX package asks for ``precision=HIGHEST`` here off the
TPU.

The incremental pieces (``FbankRingSpec`` ... ``fbank_edge_right``) are
what the engine's ``fbank_ring`` uses: every stage up to the window-level
normalization is frame-local, so the raw per-frame features of the
unchanged samples live in a ring across hops and only the new block's
frames and the window-edge frames are computed each hop. The cached stage
per kind:

* kaldi: ``log(max(mel, eps))``; snip-edges framing, no edge frames;
* speechbrain: ``10 log10(max(mel, 1e-10))`` before the top_db floor;
  zero-padded centred framing, 2 edge frames a side;
* nemo: ``log(mel + 2^-24)``; whole-signal pre-emphasis (interior frames
  see their true neighbours), reflect-padded centred framing, 2 edge
  frames a side.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops._numerics import true_f32

__all__ = [
    "FbankRingSpec",
    "fbank_block_raw",
    "fbank_edge_left",
    "fbank_edge_right",
    "fbank_ring_fill",
    "fbank_ring_spec",
    "kaldi_log_mel",
    "kaldi_mel_matrix",
    "librosa_mel_matrix",
    "log_mel_filterbank",
    "mel_filter_matrix",
    "nemo_log_mel",
    "num_fbank_frames",
    "speechbrain_log_mel",
    "speechbrain_mel_matrix",
]

_F32_EPS = float(np.finfo(np.float32).eps)
_NEMO_GUARD = 2.0**-24
_NEMO_FFT = 512


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def mel_filter_matrix(
    num_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float = None,
) -> np.ndarray:
    """Triangular mel filterbank over FFT bins rounded down from the mel
    points, (num_mels, n_fft // 2 + 1)."""
    f_max = f_max or sample_rate / 2
    hz_points = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), num_mels + 2))
    bins = np.floor((n_fft + 1) * hz_points / sample_rate).astype(int)
    filters = np.zeros((num_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, num_mels + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            filters[m - 1, k] = (k - left) / (center - left)
        for k in range(center, right):
            filters[m - 1, k] = (right - k) / (right - center)
    return filters


def num_fbank_frames(num_samples: int, n_fft: int = 400, hop: int = 160) -> int:
    """Frames of :func:`log_mel_filterbank` (no padding: whole frames only)."""
    return (num_samples - n_fft) // hop + 1


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


@lru_cache(maxsize=None)
def librosa_mel_matrix(
    num_mels: int = 80,
    n_fft: int = 512,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float = None,
) -> np.ndarray:
    """Mel filterbank in librosa's default convention (``htk=False,
    norm='slaney'``), which NeMo's preprocessor uses: the Slaney mel scale
    (linear below 1 kHz, log above) and each triangle scaled by
    ``2 / (f[m+2] - f[m])``. (num_mels, n_fft // 2 + 1)."""
    f_max = f_max or sample_rate / 2
    log_step = np.log(6.4) / 27.0

    def to_mel(hz):
        hz = np.asarray(hz, np.float64)
        safe = np.maximum(hz, 1e-10)  # both where-branches evaluate
        return np.where(hz >= 1000.0, 15.0 + np.log(safe / 1000.0) / log_step, hz * 3.0 / 200.0)

    def to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel >= 15.0, 1000.0 * np.exp(log_step * (mel - 15.0)), mel * 200.0 / 3.0)

    hz = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), num_mels + 2))
    fft_freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    lower = (fft_freqs[None, :] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    upper = (hz[2:, None] - fft_freqs[None, :]) / (hz[2:] - hz[1:-1])[:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return (weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


@lru_cache(maxsize=None)
def kaldi_mel_matrix(
    num_mels: int = 80,
    padded_window: int = 512,
    sample_rate: int = 16000,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-convention mel filterbank (as torchaudio.compliance.kaldi):
    triangles in mel space over the first ``padded_window // 2`` FFT bins
    (Nyquist excluded). (num_mels, padded_window // 2)."""

    def to_mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz) / 700.0)

    high = high_freq if high_freq > 0 else sample_rate / 2 + high_freq
    num_bins = padded_window // 2
    mel_freqs = to_mel(np.arange(num_bins) * sample_rate / padded_window)
    mel_low, mel_high = to_mel(low_freq), to_mel(high)
    delta = (mel_high - mel_low) / (num_mels + 1)
    filters = np.zeros((num_mels, num_bins), np.float32)
    for i in range(num_mels):
        left = mel_low + i * delta
        center, right = left + delta, left + 2 * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        filters[i] = np.clip(np.minimum(up, down), 0.0, None)
    return filters


def _dft_rows(dft_size: int, taps: np.ndarray, bins: int, offset: int = 0):
    """(cos, sin) DFT basis rows ``cis(-2pi k (offset+m) / dft_size)`` at tap
    positions ``m``, times the window — float64."""
    k = np.arange(bins)[:, None].astype(np.float64)
    n = (offset + np.arange(len(taps)))[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / dft_size
    return np.cos(ang) * taps[None, :], np.sin(ang) * taps[None, :]


@lru_cache(maxsize=None)
def _hann_basis(n_fft: int) -> np.ndarray:
    cos_r, sin_r = _dft_rows(n_fft, np.hanning(n_fft), n_fft // 2 + 1)
    return np.concatenate([cos_r, sin_r], 0).astype(np.float32)


@lru_cache(maxsize=None)
def _hamming_basis(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n / n_fft)  # periodic Hamming
    cos_r, sin_r = _dft_rows(n_fft, window, n_fft // 2 + 1)
    return np.concatenate([cos_r, sin_r], 0).astype(np.float32)


@lru_cache(maxsize=None)
def _nemo_basis(n_fft: int, win_length: int) -> np.ndarray:
    """A symmetric Hann(win_length) centred in n_fft; only its win_length
    nonzero taps, phase-offset by the left margin."""
    n = np.arange(win_length)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win_length - 1))
    cos_r, sin_r = _dft_rows(n_fft, hann, n_fft // 2 + 1, offset=(n_fft - win_length) // 2)
    return np.concatenate([cos_r, sin_r], 0).astype(np.float32)


@lru_cache(maxsize=None)
def _kaldi_basis(frame_length: int, padded: int, preemphasis: float, remove_dc: bool) -> np.ndarray:
    """Per-frame DC removal, pre-emphasis and the povey window are linear
    maps of the frame, folded into the DFT basis in float64. The Nyquist
    bin is left out, as kaldi's mel triangles never reach it."""
    flen = frame_length
    linear = np.eye(flen)
    if remove_dc:
        linear = linear - np.full((flen, flen), 1.0 / flen)
    if preemphasis:
        pre = np.eye(flen)
        pre[0, 0] = 1.0 - preemphasis
        for i in range(1, flen):
            pre[i, i - 1] = -preemphasis
        linear = pre @ linear
    n = np.arange(flen)
    povey = (0.5 - 0.5 * np.cos(2 * np.pi * n / (flen - 1))) ** 0.85
    linear = povey[:, None] * linear
    cos_r, sin_r = _dft_rows(padded, np.ones(flen), padded // 2)
    return np.concatenate([cos_r @ linear, sin_r @ linear], 0).astype(np.float32)


_CONSTANTS: dict = {}


def _constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy constant as a cached f32 tensor on ``device``."""
    key = (id(array), str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return t


_PHASED: dict = {}


def _phase_basis(basis: np.ndarray, hop: int) -> np.ndarray:
    """A (2 * bins, taps) DFT basis as a (2 * bins, hop, ceil(taps / hop))
    stride-1 convolution over the waveform viewed as ``hop`` interleaved
    channels (bases are cached constants, so their ids are stable keys)."""
    key = (id(basis), hop)
    w = _PHASED.get(key)
    if w is None:
        taps = basis.shape[1]
        k = -(-taps // hop)
        w = np.pad(basis, ((0, 0), (0, k * hop - taps))).reshape(-1, k, hop)
        w = _PHASED[key] = np.ascontiguousarray(np.swapaxes(w, 1, 2))
    return w


def _dft_power(signal: torch.Tensor, basis: np.ndarray, hop: int) -> torch.Tensor:
    """Power spectrum of hopped frames: signal (B, samples), frame ``t``
    starting at sample ``t * hop``; basis (2 * bins, taps) -> (B, frames,
    bins) f32.

    The waveform is viewed as ``hop`` interleaved channels, so the stride-hop
    single-channel convolution becomes a stride-1, hop-channel one (the JAX
    package's phase decomposition; exact)."""
    batch, samples = signal.shape
    bins, taps = basis.shape[0] // 2, basis.shape[1]
    num_frames = (samples - taps) // hop + 1
    k = -(-taps // hop)
    needed = (num_frames + k - 1) * hop
    x = signal[:, :needed].float()
    if needed > samples:
        x = F.pad(x, (0, needed - samples))
    x = x.reshape(batch, -1, hop).transpose(1, 2)  # (B, hop, hops)
    w = _constant(_phase_basis(basis, hop), signal.device)
    with true_f32(signal.device):
        y = F.conv1d(x, w)  # (B, 2 * bins, frames)
    power = y[:, :bins] ** 2 + y[:, bins:] ** 2
    return power.transpose(1, 2)


def _mel(power: torch.Tensor, mel: np.ndarray) -> torch.Tensor:
    """Mel energies of ``power`` (B, frames, bins) in true f32."""
    with true_f32(power.device):
        return torch.matmul(power, _constant(mel, power.device).t())


def _mel_db(power: torch.Tensor, mel: np.ndarray, amin: float = 1e-10) -> torch.Tensor:
    """10 log10 of the mel energies of ``power``, floored at ``amin`` —
    speechbrain's cached (pre top_db) stage."""
    return 10.0 * torch.log10(torch.clamp(_mel(power, mel), min=amin))


def log_mel_filterbank(
    waveform: torch.Tensor,
    num_mels: int = 80,
    n_fft: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
    eps: float = 1e-10,
) -> torch.Tensor:
    """(B, samples) -> (B, frames, num_mels) log-mel energies: whole frames
    (no padding) under a symmetric Hann window, the power spectrum through
    the DFT convolution, :func:`mel_filter_matrix`'s triangles and
    ``log(mel + eps)``, in true f32 on the waveform's device."""
    power = _dft_power(waveform, _hann_basis(n_fft), hop)
    return torch.log(_mel(power, mel_filter_matrix(num_mels, n_fft, sample_rate)) + eps)


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
    power = _dft_power(padded[:, :need], _hamming_basis(n_fft), hop)
    x_db = _mel_db(power, speechbrain_mel_matrix(num_mels, n_fft, sample_rate, f_min, f_max), amin)
    floor = x_db.amax(dim=(1, 2), keepdim=True) - top_db
    return torch.maximum(x_db, floor)


def _preemph_first_kept(x: torch.Tensor, coeff: float) -> torch.Tensor:
    """NeMo's whole-signal pre-emphasis: the first sample kept as it is."""
    return torch.cat([x[:, :1], x[:, 1:] - coeff * x[:, :-1]], dim=1)


def nemo_log_mel(
    waveform: torch.Tensor,
    num_mels: int = 80,
    n_fft: int = _NEMO_FFT,
    win_length: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
    preemph: float = 0.97,
    log_guard: float = _NEMO_GUARD,
) -> torch.Tensor:
    """(B, samples) -> (B, frames, num_mels) log-mel features in NeMo's
    ``AudioToMelSpectrogramPreprocessor`` convention (the TitaNet
    frontend): whole-signal pre-emphasis (first sample kept), centred
    reflect-padded STFT with a symmetric Hann(win_length) window inside
    ``n_fft``, power spectrum, librosa slaney mel triangles and
    ``log(x + 2^-24)``. Per-feature normalization is the caller's."""
    x = waveform.float()
    if preemph:
        x = _preemph_first_kept(x, preemph)
    samples = x.shape[1]
    pad = n_fft // 2
    padded = F.pad(x, (pad, pad), mode="reflect")
    num_frames = samples // hop + 1
    # the window is zero outside its centred span: the DFT convolution takes
    # only its win_length taps, from ``left`` samples in
    left = (n_fft - win_length) // 2
    need = (num_frames - 1) * hop + win_length
    power = _dft_power(padded[:, left : left + need], _nemo_basis(n_fft, win_length), hop)
    return torch.log(_mel(power, librosa_mel_matrix(num_mels, n_fft, sample_rate)) + log_guard)


def kaldi_log_mel(
    waveform: torch.Tensor,
    num_mels: int = 80,
    frame_length: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
    preemphasis: float = 0.97,
    remove_dc: bool = True,
) -> torch.Tensor:
    """(B, samples) -> (B, frames, num_mels) log-mel fbanks in kaldi's
    conventions (torchaudio.compliance.kaldi.fbank with dither 0, the
    WeSpeaker frontend): snip-edges framing, per-frame DC removal,
    pre-emphasis, povey window, power spectrum of a power-of-two DFT, mel
    triangles in mel space, natural log floored at the f32 epsilon."""
    padded = 1 << (frame_length - 1).bit_length()
    basis = _kaldi_basis(frame_length, padded, preemphasis, remove_dc)
    power = _dft_power(waveform.float(), basis, hop)
    mel = _mel(power, kaldi_mel_matrix(num_mels, padded, sample_rate))
    return torch.log(torch.clamp(mel, min=_F32_EPS))


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
    (B, samples) -> (B, (samples - win) // hop + 1, num_mels); for nemo, x
    is already pre-emphasized. The constants are the direct frontends'
    defaults, as the models call them."""
    if spec.kind == "kaldi":
        padded = 1 << (spec.win - 1).bit_length()
        power = _dft_power(x, _kaldi_basis(spec.win, padded, 0.97, True), spec.hop)
        mel = _mel(power, kaldi_mel_matrix(spec.num_mels, padded, spec.sample_rate))
        return torch.log(torch.clamp(mel, min=_F32_EPS))
    if spec.kind == "speechbrain":
        power = _dft_power(x, _hamming_basis(spec.win), spec.hop)
        return _mel_db(power, speechbrain_mel_matrix(spec.num_mels, spec.win, spec.sample_rate))
    if spec.kind == "nemo":
        power = _dft_power(x, _nemo_basis(_NEMO_FFT, spec.win), spec.hop)
        mel = _mel(power, librosa_mel_matrix(spec.num_mels, _NEMO_FFT, spec.sample_rate))
        return torch.log(mel + _NEMO_GUARD)
    raise ValueError(spec.kind)


_FILL = {
    "kaldi": float(np.log(np.finfo(np.float32).eps)),
    "speechbrain": -100.0,  # 10 log10(1e-10)
    "nemo": float(np.log(_NEMO_GUARD)),
}


def fbank_ring_fill(spec: FbankRingSpec) -> np.ndarray:
    """The cached-stage value of a frame of all-zero samples — what a
    never-written ring slot holds, so warm-up windows reproduce the direct
    path's zero-filled window. (num_mels,) float32."""
    return np.full(spec.num_mels, _FILL[spec.kind], np.float32)


def fbank_block_raw(spec: FbankRingSpec, tail: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Cached-stage features of the ``fpb`` frames a new block completes.
    tail: (B, >= tail_conv, + 1 for pre-emphasis) raw samples before the
    block; block: (B, step_samples) -> (B, fpb, num_mels)."""
    ctx = 1 if spec.preemph else 0
    x = torch.cat([tail[:, tail.shape[1] - spec.tail_conv - ctx :], block], dim=1)
    if spec.preemph:
        x = _preemph_first_kept(x, spec.preemph)[:, 1:]
    return _fbank_raw_frames(spec, x)[:, : spec.fpb]


def fbank_edge_left(spec: FbankRingSpec, head: torch.Tensor) -> torch.Tensor:
    """The ``edge`` window-leading frames, which read the left padding
    (zeros, or for nemo the reflected pre-emphasized signal). head:
    (B, head_len) samples from the window start -> (B, edge, num_mels)."""
    assert spec.edge
    if spec.preemph:
        xp = _preemph_first_kept(head, spec.preemph)
        x = torch.cat([xp[:, 1 : spec.pad + 1].flip(1), xp], dim=1)  # reflect, no edge repeat
    else:
        x = F.pad(head, (spec.pad, 0))
    return _fbank_raw_frames(spec, x)[:, : spec.edge]


def fbank_edge_right(spec: FbankRingSpec, tail: torch.Tensor) -> torch.Tensor:
    """The ``edge`` window-trailing frames, which read the right padding.
    tail: (B, >= right_need, + 1 for pre-emphasis) newest samples ->
    (B, edge, num_mels)."""
    assert spec.edge
    ctx = 1 if spec.preemph else 0
    t = tail[:, tail.shape[1] - spec.right_need - ctx :]
    if spec.preemph:
        xp = _preemph_first_kept(t, spec.preemph)[:, 1:]
        x = torch.cat([xp, xp[:, -1 - spec.pad : -1].flip(1)], dim=1)  # reflect at the end
    else:
        x = F.pad(t, (0, spec.pad))
    return _fbank_raw_frames(spec, x)[:, : spec.edge]
