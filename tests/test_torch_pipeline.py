"""Parity of the port's pipelines (``diart_tpu_torch.blocks``) with
diart_tpu's, on the CPU.

``SpeakerDiarization`` and ``VoiceActivityDetection`` run beside the JAX
package's on the same chunks: with torch copies of ``tests/fakes.py``'s
fake models (tones, band amplitudes) the RTTM text of every chunk's
annotation is string-equal and the aggregated audio equal, for latencies
min, 1.0 and max, batches of 1 and 4, a timestamp shift and a reset
mid-stream; on small registry models (the flax init carried over by
``load_flax_params``) the permuted scores agree within 1e-4 and the text is
equal, and the test prints the smallest distance of an aggregated score
from tau in the JAX run, which must exceed that agreement. A call on 8
chunks gives what 8 calls on one give.
"""

import jax
import numpy as np
import pytest
import torch

from diart_tpu.blocks import SpeakerDiarization as JaxSpeakerDiarization
from diart_tpu.blocks import SpeakerDiarizationConfig as JaxSpeakerDiarizationConfig
from diart_tpu.blocks import VoiceActivityDetection as JaxVoiceActivityDetection
from diart_tpu.blocks import VoiceActivityDetectionConfig as JaxVoiceActivityDetectionConfig
from diart_tpu.core.segment import SlidingWindow as JaxSlidingWindow
from diart_tpu.core.segment import SlidingWindowFeature as JaxSlidingWindowFeature
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu_torch import EmbeddingModel, SegmentationModel, precision
from diart_tpu_torch.blocks import (
    SpeakerDiarization,
    SpeakerDiarizationConfig,
    VoiceActivityDetection,
    VoiceActivityDetectionConfig,
)
from diart_tpu_torch.core.segment import SlidingWindow, SlidingWindowFeature

import fakes
from fakes import FRAME_SAMPLES, SAMPLE_RATE, SPEAKER_FREQS, TONE_AMPLITUDE, Turn, synth_audio

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
TURNS = [Turn(0.0, 3.0, 0), Turn(4.0, 7.0, 1), Turn(8.0, 11.0, 0), Turn(9.5, 12.0, 1)]
TOTAL = 13.0
FAKE_KW = dict(duration=2.0, step=0.5, tau_active=0.6, rho_update=0.1, delta_new=0.7,
               max_speakers=8, sample_rate=SAMPLE_RATE)
# small registry models: thresholds low enough that their ~0.5 activations
# map speakers
REG_KW = dict(duration=0.5, step=0.25, tau_active=0.45, rho_update=0.05, max_speakers=4,
              sample_rate=SAMPLE_RATE)
# their max over speakers lies in ~0.50-0.58 (95% below ~0.553): a VAD
# threshold in the sparse upper tail, where no score lies within 1e-4 of it
VAD_TAU = 0.56


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------- #
# torch copies of tests/fakes.py's models (fakes.py imports jax)
# --------------------------------------------------------------------- #
def _band_amplitudes(wave: torch.Tensor) -> torch.Tensor:
    """(B, 1, S) -> per-frame tone amplitudes (B, T, K) via quadrature
    correlation at each speaker frequency."""
    x = wave[:, 0, :]
    batch, samples = x.shape
    frames = x.reshape(batch, samples // FRAME_SAMPLES, FRAME_SAMPLES)
    t = torch.arange(FRAME_SAMPLES, device=wave.device) / SAMPLE_RATE
    outs = []
    for f in SPEAKER_FREQS:
        s = torch.mean(frames * torch.sin(2 * np.pi * f * t), dim=-1)
        c = torch.mean(frames * torch.cos(2 * np.pi * f * t), dim=-1)
        outs.append(2.0 * torch.sqrt(s**2 + c**2))
    return torch.stack(outs, dim=-1)


def fake_segmentation(num_speakers: int = len(SPEAKER_FREQS)) -> SegmentationModel:
    def apply_fn(wave):
        amp = _band_amplitudes(wave)[..., :num_speakers]
        return torch.clamp(amp / TONE_AMPLITUDE, 0.0, 1.0)

    return SegmentationModel.from_apply(apply_fn, sample_rate=SAMPLE_RATE,
                                        num_speakers=num_speakers, device="cpu")


def fake_embedding() -> EmbeddingModel:
    def head_fn(frames, weights):
        # weights (B, K, Tw) resampled to T by nearest
        num_frames, src = frames.shape[1], weights.shape[-1]
        idx = torch.arange(num_frames) * src // (src if src == num_frames else num_frames)
        w = weights.index_select(-1, idx)
        total = torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
        return torch.einsum("btc,bst->bsc", frames, w / total)

    return EmbeddingModel.from_apply(_band_amplitudes, head_fn, sample_rate=SAMPLE_RATE,
                                     embedding_dim=len(SPEAKER_FREQS), device="cpu")


# --------------------------------------------------------------------- #
def _chunks(audio: np.ndarray, duration: float, step: float, sr: int = SAMPLE_RATE):
    """(1, samples) -> the chunks the runtime's rearrangement gives, in both
    packages' containers: (samples, 1) data on a 1/sr sliding window."""
    win, hop = int(round(duration * sr)), int(round(step * sr))
    jax_chunks, port_chunks = [], []
    for start in range(0, audio.shape[1] - win + 1, hop):
        data = audio[0, start : start + win, None].copy()
        kw = dict(start=start / sr, duration=1.0 / sr, step=1.0 / sr)
        jax_chunks.append(JaxSlidingWindowFeature(data, JaxSlidingWindow(**kw)))
        port_chunks.append(SlidingWindowFeature(data.copy(), SlidingWindow(**kw)))
    return jax_chunks, port_chunks


def _run(pipeline, chunks, batch, reset_at=None, shift=-0.25):
    """Every chunk's (rttm, audio data, audio window start) in calls of
    ``batch`` chunks; with ``reset_at``, ``reset()`` and a timestamp shift
    before that chunk."""
    out = []
    for i in range(0, len(chunks), batch):
        if reset_at is not None and i == reset_at:
            pipeline.reset()
            pipeline.set_timestamp_shift(shift)
        for ann, audio in pipeline(chunks[i : i + batch]):
            out.append((ann.to_rttm(), np.asarray(audio.data), audio.sliding_window.start))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for k, ((g_text, g_audio, g_start), (w_text, w_audio, w_start)) in enumerate(zip(got, want)):
        assert g_text == w_text, k
        assert g_start == w_start, k
        np.testing.assert_array_equal(g_audio, w_audio, err_msg=str(k))


@pytest.mark.parametrize("latency", ["min", 1.0, "max"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["diarization", "vad"])
def test_pipeline_matches_jax_on_fakes(kind, batch, latency):
    """Both pipelines with the fake models: every chunk's RTTM text,
    aggregated audio and audio window equal to diart_tpu's, with a reset
    and a timestamp shift halfway."""
    audio = synth_audio(TURNS, TOTAL)
    jax_chunks, port_chunks = _chunks(audio, FAKE_KW["duration"], FAKE_KW["step"])
    if kind == "diarization":
        jax_pipe = JaxSpeakerDiarization(JaxSpeakerDiarizationConfig(
            segmentation=fakes.fake_segmentation(), embedding=fakes.fake_embedding(),
            latency=latency, **FAKE_KW))
        pipe = SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=fake_segmentation(), embedding=fake_embedding(), latency=latency,
            **FAKE_KW))
    else:
        kw = {k: FAKE_KW[k] for k in ("duration", "step", "tau_active", "sample_rate")}
        jax_pipe = JaxVoiceActivityDetection(JaxVoiceActivityDetectionConfig(
            segmentation=fakes.fake_segmentation(), latency=latency, **kw))
        pipe = VoiceActivityDetection(VoiceActivityDetectionConfig(
            segmentation=fake_segmentation(), latency=latency, **kw))
    reset_at = 8 * (len(port_chunks) // 16)  # a multiple of both batch sizes
    want = _run(jax_pipe, jax_chunks, batch, reset_at)
    got = _run(pipe, port_chunks, batch, reset_at)
    _assert_same(got, want)
    texts = [t for t, _, _ in got]
    assert sum(bool(t) for t in texts) > len(texts) // 2  # turns were made


# --------------------------------------------------------------------- #
# small registry models
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    jemb = JaxEmbeddingModel.from_registry("tpu/xvector", init_samples=8000, **EMB_KW).load()
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb), **EMB_KW)
    return (jseg, jemb), (pseg, pemb)


def _noise(seconds: float, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=(1, int(seconds * SAMPLE_RATE))).astype(np.float32)


def _spy_binarize(pipeline, record):
    """Record the aggregated scores the pipeline's binarize sees."""
    binarize = pipeline.binarize

    def spy(scores):
        record.append(np.asarray(scores.data))
        return binarize(scores)

    pipeline.binarize = spy


@pytest.mark.parametrize("kind", ["diarization", "vad"])
def test_pipeline_matches_jax_on_registry_models(models, kind):
    """Registry models: permuted scores per chunk within 1e-4 of diart_tpu's
    and the RTTM text equal; the JAX run's aggregated scores keep more than
    that from tau, so the equal text is not luck."""
    (jseg, jemb), (pseg, pemb) = models
    tau = REG_KW["tau_active"] if kind == "diarization" else VAD_TAU
    jax_chunks, port_chunks = _chunks(_noise(4.0), REG_KW["duration"], REG_KW["step"])
    if kind == "diarization":
        jax_pipe = JaxSpeakerDiarization(JaxSpeakerDiarizationConfig(
            segmentation=jseg, embedding=jemb, latency=0.5, **REG_KW))
        pipe = SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=pseg, embedding=pemb, latency=0.5, **REG_KW))
        scan = jax_pipe._scan_cluster
        jax_scores = []

        def spy_scan(state, segs, embs):
            state, permuted = scan(state, segs, embs)
            jax_scores.append(np.asarray(permuted))
            return state, permuted

        jax_pipe._scan_cluster = spy_scan
    else:
        kw = dict(duration=REG_KW["duration"], step=REG_KW["step"], tau_active=tau,
                  sample_rate=SAMPLE_RATE)
        jax_pipe = JaxVoiceActivityDetection(JaxVoiceActivityDetectionConfig(
            segmentation=jseg, latency=0.5, **kw))
        pipe = VoiceActivityDetection(VoiceActivityDetectionConfig(
            segmentation=pseg, latency=0.5, **kw))
        forward = jax_pipe._forward
        jax_scores = []

        def spy_forward(batch):
            out = forward(batch)
            jax_scores.append(np.asarray(out))
            return out

        jax_pipe._forward = spy_forward
    dispatch = pipe.dispatch
    port_scores = []

    def spy_dispatch(waveforms):
        out = dispatch(waveforms)
        port_scores.append(out.numpy())
        return out

    pipe.dispatch = spy_dispatch
    record = []
    _spy_binarize(jax_pipe, record)
    want = _run(jax_pipe, jax_chunks, 4)
    got = _run(pipe, port_chunks, 4)
    np.testing.assert_allclose(np.concatenate(port_scores), np.concatenate(jax_scores), atol=1e-4)
    margin = min(np.abs(r - tau).min() for r in record)
    print(f"min |score - tau| over the JAX run ({kind}): {margin:.3e}")
    assert margin > 1e-4
    _assert_same(got, want)
    texts = [t for t, _, _ in got]
    if kind == "diarization":
        assert sum(t.count("\n") for t in texts) > len(texts)  # turns were made
    else:
        assert any(texts) and not all(texts)  # speech and silence


@pytest.mark.parametrize("models_kind", ["fakes", "registry"])
def test_batch_size_invariance(models, models_kind):
    """A call on 8 chunks gives what 8 calls on one give (text, audio; on
    the registry models the scores to 1e-5)."""
    if models_kind == "fakes":
        make = lambda: SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=fake_segmentation(), embedding=fake_embedding(), **FAKE_KW))
        audio, kw = synth_audio(TURNS, TOTAL), FAKE_KW
    else:
        _, (pseg, pemb) = models
        make = lambda: SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=pseg, embedding=pemb, latency=0.5, **REG_KW))
        audio, kw = _noise(3.0, seed=9), REG_KW
    _, chunks = _chunks(audio, kw["duration"], kw["step"])
    chunks = chunks[:16]
    runs = {}
    for batch in (1, 8):
        pipe, scores = make(), []
        dispatch = pipe.dispatch
        pipe.dispatch = lambda w, d=dispatch: scores.append(d(w)) or scores[-1]
        runs[batch] = (_run(pipe, chunks, batch), torch.cat(scores))
    _assert_same(runs[8][0], runs[1][0])
    torch.testing.assert_close(runs[8][1], runs[1][1], atol=1e-5, rtol=0)
    assert any(t.count("\n") for t, _, _ in runs[1][0])


def test_pipelines_default_to_the_card():
    """Without a device the config builds its models on the card, which
    raises here; models that are passed in set the device, and another
    device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU is available"):
        SpeakerDiarizationConfig()
    with pytest.raises(RuntimeError, match="no GPU is available"):
        VoiceActivityDetectionConfig()
    seg, emb = fake_segmentation(), fake_embedding()
    assert SpeakerDiarizationConfig(segmentation=seg, embedding=emb).device.type == "cpu"
    with pytest.raises(ValueError, match="models are on cpu"):
        SpeakerDiarizationConfig(segmentation=seg, embedding=emb, device="cuda")
    with pytest.raises(ValueError, match="models are on cpu"):
        VoiceActivityDetectionConfig(segmentation=seg, device="cuda")
    config = SpeakerDiarizationConfig(segmentation=seg, embedding=emb, device="cpu", latency="max")
    assert config.latency == config.duration


@pytest.mark.parametrize("kind", ["diarization", "vad"])
def test_pipelines_follow_the_active_precision_policy(kind):
    """The forward runs under the precision policy that is active when the
    pipeline is called, not the one active when it was built."""
    seen, inner = [], fake_segmentation()
    seg = SegmentationModel.from_apply(lambda wave: seen.append(precision.active()) or inner(wave),
                                       sample_rate=SAMPLE_RATE, num_speakers=inner.num_speakers,
                                       device="cpu")
    if kind == "diarization":
        pipe = SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=seg, embedding=fake_embedding(), **FAKE_KW))
    else:
        pipe = VoiceActivityDetection(VoiceActivityDetectionConfig(
            segmentation=seg, duration=FAKE_KW["duration"], step=FAKE_KW["step"],
            sample_rate=SAMPLE_RATE))
    _, chunks = _chunks(synth_audio(TURNS, TOTAL), FAKE_KW["duration"], FAKE_KW["step"])
    policy = precision.Precision.portable()
    with precision.use(policy):
        pipe(chunks[:2])
    pipe(chunks[2:3])
    assert seen == [policy, precision.Precision()]
