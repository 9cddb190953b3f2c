"""Parity of the port's runtime (``diart_tpu_torch.runtime``,
``metrics.parity``, ``precision``) with diart_tpu's, on the CPU.

The port runs with ``device="cpu"`` (its kernels' plain versions) on torch
copies of ``tests/fakes.py``'s fake models (``tests/test_torch_pipeline.py``;
``fakes.py`` imports jax), and diart_tpu runs on the JAX CPU backend, both
on the same seeded audio. Tolerances:

* RTTM text: string-equal to diart_tpu's, always (the fakes' tones sit far
  from every threshold).
* Against the committed ``tests/golden/*.rttm`` fixtures: ``test_golden.py``'s
  own rule, bit-exact or a DER drift below 0.005; the test prints which held.
* Rechunked windows, source blocks and padding: exactly equal (same start
  times, same samples).
* ``Benchmark`` totals, sequential against multi-stream: within 2 DER
  points, the JAX test's own bound (``tests/test_tools.py``); the
  per-file reports of the two packages within 1e-9 (same text, same metric
  code).
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import diart_tpu.precision as jax_precision
from diart_tpu import SpeakerDiarization as JaxSpeakerDiarization
from diart_tpu import SpeakerDiarizationConfig as JaxSpeakerDiarizationConfig
from diart_tpu import VoiceActivityDetection as JaxVoiceActivityDetection
from diart_tpu import VoiceActivityDetectionConfig as JaxVoiceActivityDetectionConfig
from diart_tpu.core import write_rttm as jax_write_rttm
from diart_tpu.metrics.parity import score_rttm as jax_score_rttm
from diart_tpu.runtime import Benchmark as JaxBenchmark
from diart_tpu.runtime import FFmpegAudioSource as JaxFFmpegAudioSource
from diart_tpu.runtime import FileAudioSource as JaxFileAudioSource
from diart_tpu.runtime import IteratorAudioSource as JaxIteratorAudioSource
from diart_tpu.runtime import StreamingInference as JaxStreamingInference
from diart_tpu.runtime.operators import SlidingChunker as JaxSlidingChunker
from diart_tpu.runtime.operators import rearrange_audio_stream as jax_rearrange
from diart_tpu_torch import precision
from diart_tpu_torch.audio import write_wav
from diart_tpu_torch.blocks import (
    SpeakerDiarization,
    SpeakerDiarizationConfig,
    VoiceActivityDetection,
    VoiceActivityDetectionConfig,
)
from diart_tpu_torch.core import load_rttm
from diart_tpu_torch.metrics import DiarizationErrorRate
from diart_tpu_torch.metrics.parity import score_rttm
from diart_tpu_torch.runtime import (
    Benchmark,
    FFmpegAudioSource,
    FileAudioSource,
    IteratorAudioSource,
    Parallelize,
    PredictionAccumulator,
    RTTMWriter,
    SlidingChunker,
    StreamingInference,
    rearrange_audio_stream,
)
from diart_tpu_torch.runtime.rx import Observer

import golden_config
from fakes import SAMPLE_RATE, Turn, synth_audio, turns_to_annotation
from test_torch_pipeline import fake_embedding, fake_segmentation

GOLDEN_DIR = Path(__file__).parent / "golden"
TURNS = [Turn(0.0, 3.0, 0), Turn(4.0, 7.0, 1), Turn(8.0, 11.0, 0), Turn(9.5, 12.0, 1)]
TOTAL = 13.0
PARAMS = dict(duration=2.0, step=0.5, latency=0.5, tau_active=0.6, rho_update=0.1,
              delta_new=0.7, max_speakers=8, sample_rate=SAMPLE_RATE)
VAD_KEYS = ("duration", "step", "latency", "tau_active", "sample_rate")
CORPUS = {
    "conv1": [Turn(0.0, 3.0, 0), Turn(4.0, 7.0, 1)],
    "conv2": [Turn(0.5, 2.5, 2), Turn(3.0, 6.0, 0), Turn(6.5, 8.0, 2)],
    "conv3": [Turn(0.0, 2.0, 1), Turn(2.5, 4.0, 0), Turn(4.5, 6.0, 1)],
}
# files of different lengths, so the multi-stream run pads and pauses streams
CORPUS_TOTAL = {"conv1": 8.0, "conv2": 9.0, "conv3": 6.5}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_config(pipeline="diarization", **overrides):
    params = {**PARAMS, **overrides}
    if pipeline == "vad":
        return VoiceActivityDetectionConfig(
            segmentation=fake_segmentation(), **{k: params[k] for k in VAD_KEYS})
    return SpeakerDiarizationConfig(segmentation=fake_segmentation(), embedding=fake_embedding(),
                                    **params)


def jax_config(pipeline="diarization", **overrides):
    import fakes

    params = {**PARAMS, **overrides}
    if pipeline == "vad":
        return JaxVoiceActivityDetectionConfig(
            segmentation=fakes.fake_segmentation(), **{k: params[k] for k in VAD_KEYS})
    return JaxSpeakerDiarizationConfig(segmentation=fakes.fake_segmentation(),
                                       embedding=fakes.fake_embedding(), **params)


PORT_PIPELINES = {"diarization": SpeakerDiarization, "vad": VoiceActivityDetection}
JAX_PIPELINES = {"diarization": JaxSpeakerDiarization, "vad": JaxVoiceActivityDetection}


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("audio") / "synth.wav"
    write_wav(path, synth_audio(TURNS, TOTAL), SAMPLE_RATE)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    audio_dir, rttm_dir = root / "audio", root / "rttm"
    audio_dir.mkdir()
    rttm_dir.mkdir()
    for i, (uri, turns) in enumerate(CORPUS.items()):
        write_wav(audio_dir / f"{uri}.wav", synth_audio(turns, CORPUS_TOTAL[uri], seed=i), SAMPLE_RATE)
        jax_write_rttm(turns_to_annotation(turns, uri), rttm_dir / f"{uri}.rttm")
    return audio_dir, rttm_dir


def stream_file(pipeline, source_cls, inference_cls, wav, batch_size=1, observers=()):
    """diart's file route: padding, timestamp shift, StreamingInference."""
    config = pipeline.config
    padding = config.get_file_padding(wav)
    source = source_cls(wav, SAMPLE_RATE, padding, config.step)
    pipeline.set_timestamp_shift(-padding[0])
    inference = inference_cls(pipeline, source, batch_size=batch_size, do_profile=False,
                              show_progress=False)
    inference.attach_observers(*observers)
    return inference(), source


# --------------------------------------------------------------------- #
# Golden fixtures
# --------------------------------------------------------------------- #
def _port_golden(turns, total, duration, latency, seed, **hparams) -> str:
    """``golden_config._run`` on the port: FileAudioSource + StreamingInference
    on the torch fakes."""
    config = SpeakerDiarizationConfig(
        segmentation=fake_segmentation(), embedding=fake_embedding(), duration=duration, step=0.5,
        latency=latency, max_speakers=8, sample_rate=SAMPLE_RATE, **hparams)
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "synth.wav"
        write_wav(wav, synth_audio(turns, total, seed=seed), SAMPLE_RATE)
        prediction, _ = stream_file(SpeakerDiarization(config), FileAudioSource, StreamingInference, wav)
    prediction.uri = "synth"
    return prediction.to_rttm()


GRID_HPARAMS = {"tau_active": 0.6, "rho_update": 0.3, "delta_new": 1.0}
GOLDEN_CASES = (
    [(f"synth_latency{lat}.rttm", golden_config.GOLDEN_TURNS, golden_config.TOTAL, 2.0, lat, 123,
      dict(tau_active=0.6, rho_update=0.1, delta_new=0.7), lambda lat=lat: golden_config.run_golden(lat))
     for lat in golden_config.GOLDEN_LATENCIES]
    + [(f"synth5s_latency{lat}.rttm", golden_config.GRID_TURNS, golden_config.GRID_TOTAL, 5.0, lat, 321,
        GRID_HPARAMS, lambda lat=lat: golden_config.run_golden_grid(lat))
       for lat in golden_config.GRID_LATENCIES]
    + [("synth5s_tuned_latency5.0.rttm", golden_config.GRID_TURNS, golden_config.GRID_TOTAL, 5.0, 5.0,
        321, golden_config.TUNED_HPARAMS, lambda: golden_config.run_golden_grid(5.0, tuned=True))]
)


def _parse_rttm(text):
    with tempfile.NamedTemporaryFile("w", suffix=".rttm", delete=False) as f:
        f.write(text)
    return next(iter(load_rttm(f.name).values()))


@pytest.mark.parametrize("case", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_golden_fixture(case):
    """All nine committed fixtures through the port's FileAudioSource +
    StreamingInference: the text equals the JAX run's, and holds the
    fixture under test_golden.py's rule (bit-exact, else DER drift < 0.005)."""
    fixture, turns, total, duration, latency, seed, hparams, jax_run = case
    text = _port_golden(turns, total, duration, latency, seed, **hparams)
    assert text == jax_run()
    golden = (GOLDEN_DIR / fixture).read_text()
    if text == golden:
        print(f"{fixture}: bit-exact")
        return
    drift = DiarizationErrorRate()(_parse_rttm(golden), _parse_rttm(text))
    print(f"{fixture}: DER drift {drift:.6f} (limit 0.005)")
    assert drift < 0.005


# --------------------------------------------------------------------- #
# Rechunking and sources
# --------------------------------------------------------------------- #
def _irregular_blocks(total: int, seed: int, lo=100, hi=9000):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=total).astype(np.float32)
    pieces, start = [], 0
    while start < total:
        n = min(int(rng.integers(lo, hi)), total - start)
        pieces.append(audio[None, start : start + n])
        start += n
    return pieces


@pytest.mark.parametrize("window,hop", [(16000, 4000), (16000, 8000), (8000, 8000),
                                        (16000, 32000), (4000, 12345)])
def test_sliding_chunker_matches_jax(window, hop):
    """Irregular blocks, hops smaller than, equal to and larger than the
    window: the same windows as JAX's chunker, exactly, block by block."""
    port, ref = SlidingChunker(window, hop, SAMPLE_RATE), JaxSlidingChunker(window, hop, SAMPLE_RATE)
    emitted = 0
    for block in _irregular_blocks(5 * SAMPLE_RATE + 777, seed=window + hop):
        got, want = port.push(block), ref.push(block)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.sliding_window.start == w.sliding_window.start
            assert g.sliding_window.step == w.sliding_window.step
            np.testing.assert_array_equal(g.data, w.data)
        emitted += len(got)
    assert emitted >= 2


@pytest.mark.parametrize("duration,step", [(1.0, 0.25), (2.0, 0.5), (0.5, 1.5)])
def test_rearrange_audio_stream_matches_jax(duration, step):
    """rearrange_audio_stream over an IteratorAudioSource of irregular
    blocks: the same windows as JAX's operator, exactly."""
    blocks = _irregular_blocks(4 * SAMPLE_RATE, seed=7)
    outs = []
    for source_cls, op in ((IteratorAudioSource, rearrange_audio_stream),
                           (JaxIteratorAudioSource, jax_rearrange)):
        chunks = []
        source = source_cls("it", SAMPLE_RATE, list(blocks))
        source.stream.pipe(op(duration, step, SAMPLE_RATE)).subscribe(on_next=chunks.append)
        source.read()
        outs.append(chunks)
    assert len(outs[0]) == len(outs[1]) > 0
    for g, w in zip(*outs):
        assert g.extent.start == w.extent.start
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("padding,block", [((0.0, 0.0), 0.5), ((1.0, 0.5), 0.5), ((0.3, 0.7), 0.25)])
def test_file_source_matches_jax(wav_file, padding, block):
    """FileAudioSource: duration, block shapes, padding and samples equal
    JAX's, exactly."""
    got, want = [], []
    port = FileAudioSource(wav_file, SAMPLE_RATE, padding=padding, block_duration=block)
    ref = JaxFileAudioSource(wav_file, SAMPLE_RATE, padding=padding, block_duration=block)
    assert port.duration == ref.duration
    assert port.uri == ref.uri == "synth"
    port.stream.subscribe(on_next=got.append)
    ref.stream.subscribe(on_next=want.append)
    port.read()
    ref.read()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, int(round(block * SAMPLE_RATE)))
        np.testing.assert_array_equal(g, w)
    if padding[0] > 0:
        assert np.abs(got[0]).max() == 0.0


def _fake_ffmpeg(path: Path, body: str) -> str:
    """A stand-in ffmpeg binary (tests/test_sources_ffmpeg.py's approach)."""
    path.write_text(f"#!{sys.executable}\n{body}")
    path.chmod(0o755)
    return str(path)


COPY_INPUT = ("import sys\nargs = sys.argv[1:]\npath = args[args.index('-i') + 1]\n"
              "assert 'f32le' in args and '-ac' in args, args\n"
              "sys.stdout.buffer.write(open(path, 'rb').read())\n")


def _collect(source):
    events = []
    source.stream.subscribe(on_next=events.append, on_error=events.append)
    source.read()
    return events


def test_ffmpeg_source_matches_jax(tmp_path):
    """FFmpegAudioSource through a fake ffmpeg: the same command line, the
    same blocks (a partial last one included) as JAX's, exactly; a failing
    decoder reaches on_error once with its stderr in both."""
    binary = _fake_ffmpeg(tmp_path / "ffmpeg", COPY_INPUT)
    signal = np.random.default_rng(0).normal(scale=0.1, size=2 * SAMPLE_RATE + 123).astype(np.float32)
    raw = tmp_path / "clip.f32"
    raw.write_bytes(signal.tobytes())
    port = FFmpegAudioSource(raw, SAMPLE_RATE, block_duration=0.5, binary=binary)
    ref = JaxFFmpegAudioSource(raw, SAMPLE_RATE, block_duration=0.5, binary=binary)
    assert port.uri == ref.uri == "clip"
    assert port._command() == ref._command()
    got, want = _collect(port), _collect(ref)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), signal)

    bad = _fake_ffmpeg(tmp_path / "ffmpeg_bad",
                       "import sys\nsys.stderr.write('boom: unsupported codec')\nsys.exit(3)\n")
    errors = [_collect(cls(raw, SAMPLE_RATE, binary=bad))
              for cls in (FFmpegAudioSource, JaxFFmpegAudioSource)]
    for events in errors:
        assert len(events) == 1 and isinstance(events[0], RuntimeError)
        assert "boom: unsupported codec" in str(events[0])
    assert str(errors[0][0]) == str(errors[1][0])
    with pytest.raises(FileNotFoundError, match="not found on PATH"):
        FFmpegAudioSource("x.mp3", SAMPLE_RATE, binary="no-such-ffmpeg-xyz")


@pytest.mark.parametrize("name", ["microphone", "torchaudio"])
def test_optional_sources_raise_without_their_package(monkeypatch, name):
    """The sources with optional packages import them lazily and raise
    ImportError as JAX's do when the package is missing."""
    from diart_tpu_torch.runtime import MicrophoneAudioSource, TorchStreamAudioSource

    if name == "microphone":
        monkeypatch.setitem(sys.modules, "sounddevice", None)
        with pytest.raises(ImportError, match="sounddevice"):
            MicrophoneAudioSource()
    else:
        monkeypatch.setitem(sys.modules, "torchaudio", None)
        monkeypatch.setitem(sys.modules, "torchaudio.io", None)
        with pytest.raises(ImportError, match="torchaudio"):
            TorchStreamAudioSource("u", SAMPLE_RATE)


# --------------------------------------------------------------------- #
# StreamingInference
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_texts(wav_file):
    """JAX's StreamingInference text per pipeline, at batch size 1."""
    out = {}
    for kind in PORT_PIPELINES:
        pred, _ = stream_file(JAX_PIPELINES[kind](jax_config(kind)), JaxFileAudioSource,
                              JaxStreamingInference, wav_file)
        out[kind] = pred.to_rttm()
    return out


@pytest.mark.parametrize("batch_size", [1, 4, 8])
@pytest.mark.parametrize("kind", ["diarization", "vad"])
def test_streaming_inference_matches_jax(wav_file, tmp_path, jax_texts, kind, batch_size):
    """Both pipelines at batch sizes 1, 4 and 8: the text of JAX's run at
    batch size 1, and RTTMWriter's file equals PredictionAccumulator's
    prediction (an extra accumulator attached as an observer)."""
    path = tmp_path / "out.rttm"
    acc = PredictionAccumulator("synth")
    pred, source = stream_file(PORT_PIPELINES[kind](port_config(kind)), FileAudioSource,
                               StreamingInference, wav_file, batch_size,
                               observers=(RTTMWriter("synth", path), acc))
    assert pred.to_rttm() == jax_texts[kind]
    assert pred.to_rttm().count("\n") >= 2
    assert path.read_text() == acc.get_prediction().to_rttm() == pred.to_rttm()


class _Counter(Observer):
    def __init__(self):
        self.next = self.errors = self.completed = 0

    def on_next(self, value):
        self.next += 1

    def on_error(self, error):
        self.errors += 1

    def on_completed(self):
        self.completed += 1


@pytest.mark.parametrize("batch_size", [1, 4])
def test_error_reaches_each_observer_once(wav_file, tmp_path, batch_size):
    """A pipeline that fails on its third call: every attached observer sees
    the error once and no completion, the source closes, and RTTMWriter
    keeps (patched) the turns it had."""
    pipeline = SpeakerDiarization(port_config())
    calls, real = [0], pipeline.__call__

    class Failing:
        config = pipeline.config

        def set_timestamp_shift(self, shift):
            pipeline.set_timestamp_shift(shift)

        def __call__(self, chunks):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("boom")
            return real(chunks)

    counters = (_Counter(), _Counter())
    path = tmp_path / "partial.rttm"
    writer = RTTMWriter("synth", path)
    pred, source = stream_file(Failing(), FileAudioSource, StreamingInference, wav_file,
                               batch_size, observers=(*counters, writer))
    assert source.is_closed
    for c in counters:
        assert (c.errors, c.completed) == (1, 0)
        assert c.next == 2 * batch_size
    assert path.read_text() == writer._merged.to_rttm()


# --------------------------------------------------------------------- #
# Benchmark and Parallelize
# --------------------------------------------------------------------- #
def _texts(out_dir: Path):
    return {p.stem: p.read_text() for p in sorted(out_dir.glob("*.rttm"))}


@pytest.mark.parametrize("kind", ["diarization", "vad"])
def test_benchmark_matches_jax(corpus, tmp_path, kind):
    """Per file and multi-stream, both pipelines, on a three-file corpus of
    different lengths: each file's text equals JAX's Benchmark in the same
    mode, the reports agree within 1e-9, and the sequential and
    multi-stream totals agree within 2 DER points."""
    audio_dir, rttm_dir = corpus
    name = PORT_PIPELINES[kind].suggest_metric().name
    totals = {}
    for multi in (False, True):
        out = {}
        for pkg, bench_cls, pipeline_cls, config in (
                ("port", Benchmark, PORT_PIPELINES[kind], port_config(kind)),
                ("jax", JaxBenchmark, JAX_PIPELINES[kind], jax_config(kind))):
            path = tmp_path / f"{pkg}_{multi}"
            report = bench_cls(audio_dir, rttm_dir, path, show_progress=False, show_report=False,
                               batch_size=4, multi_stream=multi)(pipeline_cls, config)
            out[pkg] = (_texts(path), report)
        (port_texts, port_report), (jax_texts, jax_report) = out["port"], out["jax"]
        assert set(port_texts) == set(CORPUS)
        assert port_texts == jax_texts
        assert all(t.count("\n") for t in port_texts.values())
        np.testing.assert_allclose(port_report.to_numpy(float), jax_report.to_numpy(float),
                                   rtol=0, atol=1e-9)
        totals[multi] = port_report.loc["TOTAL", name]["%"]
    assert abs(totals[False] - totals[True]) < 2.0, totals


def test_multi_stream_engine_cache(corpus, tmp_path):
    """run_multi_stream keeps one engine per model configuration: a second
    call with other hyper-parameters reuses it (set_hyperparameters, no
    rebuild) and gives the text of a fresh engine at those values; the
    cached engine stays in the caller's process when pickled."""
    import pickle

    audio_dir, _ = corpus
    bench = Benchmark(audio_dir, None, tmp_path / "a", show_progress=False, multi_stream=True)
    config = port_config()
    bench(SpeakerDiarization, config)
    engine = bench._engine_cache[1]
    config.tau_active, config.delta_new = 0.55, 0.9
    reused = [p.to_rttm() for p in bench(SpeakerDiarization, config)]
    assert bench._engine_cache[1] is engine
    fresh = [p.to_rttm() for p in Benchmark(audio_dir, None, tmp_path / "b", show_progress=False,
                                            multi_stream=True)(SpeakerDiarization, config)]
    assert reused == fresh
    assert "_engine_cache" not in pickle.loads(pickle.dumps(bench)).__dict__


def test_benchmark_without_reference_needs_no_pandas(corpus, tmp_path, monkeypatch):
    """Without a reference path, Benchmark (both modes) returns predictions
    and imports no pandas."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    audio_dir, _ = corpus
    for multi in (False, True):
        preds = Benchmark(audio_dir, None, tmp_path / str(multi), show_progress=False,
                          batch_size=4, multi_stream=multi)(SpeakerDiarization, port_config())
        assert [p.uri for p in preds] == sorted(CORPUS)


def test_parallelize_matches_sequential(corpus, tmp_path, monkeypatch):
    """Two spawn workers over small registry models on the CPU (the config
    crosses in shared memory) give the sequential Benchmark's text."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the workers' compute threads

    audio_dir, _ = corpus
    config = SpeakerDiarizationConfig(
        segmentation=SegmentationModel.from_registry(
            "tpu/pyannet", device="cpu", seed=0, num_speakers=3, lstm_hidden=8, lstm_layers=1,
            linear_dims=(8,)),
        embedding=EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, embedding_dim=16),
        **{**PARAMS, "tau_active": 0.45, "rho_update": 0.05})
    seq = Benchmark(audio_dir, None, tmp_path / "seq", show_progress=False, batch_size=8)
    par = Parallelize(Benchmark(audio_dir, None, tmp_path / "par", show_progress=False, batch_size=8),
                      num_workers=2)
    seq_preds = seq(SpeakerDiarization, config)
    par_preds = par(SpeakerDiarization, config)
    assert [p.to_rttm() for p in par_preds] == [p.to_rttm() for p in seq_preds]
    assert _texts(tmp_path / "par") == _texts(tmp_path / "seq")
    assert sum(p.to_rttm().count("\n") for p in seq_preds) > 0


def test_score_rttm_matches_jax(corpus, tmp_path):
    """score_rttm over a hypothesis directory (one URI perturbed, one in a
    multi-URI file): the report equals JAX's within 1e-9."""
    audio_dir, rttm_dir = corpus
    hyp = tmp_path / "hyp"
    hyp.mkdir()
    texts = {p.stem: p.read_text() for p in rttm_dir.glob("*.rttm")}
    shifted = texts["conv1"].replace("SPEAKER conv1 1 0.000", "SPEAKER conv1 1 0.400")
    (hyp / "conv1.rttm").write_text(shifted)
    (hyp / "rest.rttm").write_text(texts["conv2"] + texts["conv3"])
    port, ref = score_rttm(hyp, rttm_dir), jax_score_rttm(hyp, rttm_dir)
    assert list(port.index) == list(ref.index)
    np.testing.assert_allclose(port.to_numpy(float), ref.to_numpy(float), rtol=0, atol=1e-9)
    assert port.loc["TOTAL", ("diarization error rate", "%")] > 0


# --------------------------------------------------------------------- #
# precision
# --------------------------------------------------------------------- #
SHARED_SPECS = ["bf16_lstm=0", "fbank_ring=off,bf16_frontend", "bf16_lstm=false, fbank_ring=1", "",
                "bf16_frontend=", "int8_trunk", "int8_trunk=1,bf16_lstm=0"]


@pytest.mark.parametrize("spec", SHARED_SPECS)
def test_precision_parse_matches_jax(spec):
    """parse on the shared switches: the same values as JAX's."""
    got, want = precision.Precision.parse(spec), jax_precision.Precision.parse(spec)
    assert got.as_dict() == {k: v for k, v in want.as_dict().items() if k in got.as_dict()}


@pytest.mark.parametrize("spec", ["pallas_lstm=1", "lstm_block", "bf16_lstm=1,nope=0"])
def test_precision_parse_rejects_unknown(spec):
    """A switch the port does not have raises ValueError, the JAX-only ones
    too (JAX raises on names it does not know)."""
    with pytest.raises(ValueError, match="unknown precision switch"):
        precision.Precision.parse(spec)
    with pytest.raises(ValueError):
        jax_precision.Precision.parse("nope=1")


def test_precision_from_dict_and_set_default():
    """from_dict keeps the shared switches of a JAX policy's dict (and drops
    the rest, as JAX's drops names it does not know); set_default reaches
    other threads, which a use() scope does not."""
    import threading

    jax_policy = jax_precision.Precision.parse("bf16_lstm=0,fbank_ring=0,int8_trunk=1")
    got = precision.Precision.from_dict(jax_policy.as_dict())
    assert got == precision.Precision(bf16_lstm=False, bf16_frontend=True, fbank_ring=False,
                                      int8_trunk=True)
    assert precision.Precision.from_dict(got.as_dict()) == got
    seen = []
    policy = precision.Precision.portable()
    prev = precision.active()
    try:
        with precision.use(policy):
            t = threading.Thread(target=lambda: seen.append(precision.active()))
            t.start()
            t.join()
        precision.set_default(policy)
        t = threading.Thread(target=lambda: seen.append(precision.active()))
        t.start()
        t.join()
    finally:
        precision.set_default(prev)
    assert seen == [prev, policy]
    assert precision.active() == prev
