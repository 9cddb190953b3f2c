"""The generic log-mel frontend of the port (``models/fbank.py``:
``mel_filter_matrix``, ``num_fbank_frames``, ``log_mel_filterbank``)
against diart_tpu's on the CPU: the filterbank exactly, the frame count
equal, the features within 1e-4 absolute (f32 on both sides; diart_tpu's
DFT convolution at ``precision=HIGHEST`` off the TPU, the port's in true
f32), and where spectra have deep valleys, as set out above
``test_log_mel_filterbank_with_spectral_valleys``."""

import numpy as np
import pytest
import torch

from diart_tpu.models import fbank as jax_fbank
from diart_tpu_torch import models
from diart_tpu_torch.models import fbank

LOG_MEL_TOL = 1e-4
GEOMETRIES = [
    dict(num_mels=80, n_fft=400, hop=160, sample_rate=16000),
    dict(num_mels=40, n_fft=512, hop=128, sample_rate=16000),
    dict(num_mels=24, n_fft=256, hop=80, sample_rate=8000),
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_mel_filter_matrix_is_exact(geometry):
    args = (geometry["num_mels"], geometry["n_fft"], geometry["sample_rate"])
    got, want = fbank.mel_filter_matrix(*args), jax_fbank.mel_filter_matrix(*args)
    assert got.dtype == want.dtype == np.float32 and got.shape == (args[0], args[1] // 2 + 1)
    np.testing.assert_array_equal(got, want)
    assert fbank.mel_filter_matrix(*args) is got  # cached, as the JAX one
    np.testing.assert_array_equal(fbank.mel_filter_matrix(40, 400, 16000, 300.0, 7000.0),
                                  jax_fbank.mel_filter_matrix(40, 400, 16000, 300.0, 7000.0))


@pytest.mark.parametrize("samples", [400, 401, 559, 560, 16000, 80000])
@pytest.mark.parametrize("n_fft, hop", [(400, 160), (512, 128)])
def test_num_fbank_frames_equal(samples, n_fft, hop):
    assert fbank.num_fbank_frames(samples, n_fft, hop) == jax_fbank.num_fbank_frames(samples, n_fft, hop)


def _signals(sample_rate: int) -> dict:
    """2 x 16000 samples from a numpy seed: white noise at two loudness
    levels (a flat spectrum), noise with a tone in half of one stream
    (tests/test_models.py's embedding input) and pure tones (its fbank
    test's)."""
    rng = np.random.default_rng(11)
    t = np.arange(16000) / sample_rate
    noise = rng.normal(size=(2, 16000)).astype(np.float32) * np.array([[0.1], [1e-3]], np.float32)
    noise_tone = rng.normal(scale=0.1, size=(2, 16000)).astype(np.float32)
    noise_tone[0, :8000] += np.sin(2 * np.pi * 440 * t[:8000]).astype(np.float32)
    tones = np.stack([np.sin(2 * np.pi * f * t) for f in (300.0, 2000.0)]).astype(np.float32)
    return dict(noise=noise, noise_tone=noise_tone, tones=tones)


def _mel_float64(wave, num_mels, n_fft, hop, sample_rate):
    """The mel energies in float64: framed, Hann-windowed, numpy's rfft."""
    w = wave.astype(np.float64)
    frames = np.stack([w[:, i * hop:i * hop + n_fft] for i in range((w.shape[1] - n_fft) // hop + 1)], 1)
    power = np.abs(np.fft.rfft(frames * np.hanning(n_fft), axis=-1)) ** 2
    return power @ fbank.mel_filter_matrix(num_mels, n_fft, sample_rate).astype(np.float64).T


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_log_mel_filterbank_matches_jax(geometry):
    """White noise, 2 x 16000 samples, one stream 40 dB below the other:
    (B, frames, num_mels) within 1e-4 of diart_tpu's everywhere."""
    wave = _signals(geometry["sample_rate"])["noise"]
    got = fbank.log_mel_filterbank(torch.from_numpy(wave), **geometry)
    want = np.asarray(jax_fbank.log_mel_filterbank(wave, **geometry))
    frames = fbank.num_fbank_frames(16000, geometry["n_fft"], geometry["hop"])
    assert got.dtype == torch.float32 and got.shape == (2, frames, geometry["num_mels"]) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOG_MEL_TOL)


# An f32 DFT's error in a bin is relative to the frame's energy, not the
# bin's: a bin 60 dB below the frame's peak (a tone's valleys) carries a
# relative error near 1e-3 in either package, and its log does too. So
# where spectra have valleys the log features are held to 1e-4 in the bins
# within 30 dB of the frame's peak, and every mel energy to 2e-6 of the
# frame's peak against a float64 oracle, which diart_tpu's meet as well.
VALLEY_FLOOR, PEAK_TOL = 1e-3, 2e-6


@pytest.mark.parametrize("kind", ["noise_tone", "tones"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_log_mel_filterbank_with_spectral_valleys(geometry, kind):
    wave = _signals(geometry["sample_rate"])[kind]
    got = fbank.log_mel_filterbank(torch.from_numpy(wave), **geometry).numpy()
    want = np.asarray(jax_fbank.log_mel_filterbank(wave, **geometry))
    ref = _mel_float64(wave, **geometry)
    peak = ref.max(axis=-1, keepdims=True)
    strong = ref >= VALLEY_FLOOR * peak
    assert strong.any(axis=-1).all()  # every frame has bins to compare
    np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=LOG_MEL_TOL)
    for out in (got, want):
        energy = np.exp(out.astype(np.float64)) - 1e-10
        assert (np.abs(energy - ref) / peak).max() <= PEAK_TOL


def test_log_mel_filterbank_exports_and_eps():
    """The package exports it as diart_tpu.models does; ``eps`` is the
    floor of silent bins."""
    assert models.log_mel_filterbank is fbank.log_mel_filterbank
    assert models.mel_filter_matrix is fbank.mel_filter_matrix
    assert models.num_fbank_frames is fbank.num_fbank_frames
    silent = torch.zeros(1, 4000)
    for eps in (1e-10, 1e-6):
        out = fbank.log_mel_filterbank(silent, eps=eps)
        np.testing.assert_allclose(out.numpy(), np.full(out.shape, np.log(np.float32(eps))), rtol=1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_fbank.log_mel_filterbank(silent.numpy(), eps=eps)),
                                   rtol=1e-6)
