"""Parity of the port's host blocks, metrics, audio and features with
diart_tpu's, on the CPU, plus the port's own checks.

The numpy modules the port copies (``blocks/mapping.py``,
``blocks/clustering.py``, ``blocks/aggregation.py``, ``metrics/der.py``,
``audio.py``, ``native/wavio.cpp``) are held to the JAX package's exactly
(DER to 1e-12) on seeded inputs; the tensor blocks (``Resample``,
``AdjustVolume``) within 1e-5; the model blocks (``SpeakerSegmentation``,
``OverlapAwareSpeakerEmbedding``) on small registry models (the flax init
carried over by ``load_flax_params``) within 1e-4, for every container
kind. Also: the port's pipeline API imports without jax, diart_tpu or
pandas, and the two session repairs (float tensor blocks are quantized
like numpy ones; ``collect_audio`` takes tensor blocks).
"""

import importlib
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diart_tpu import audio as jax_audio
from diart_tpu import blocks as jax_blocks
from diart_tpu import metrics as jax_metrics
from diart_tpu import utils as jax_utils
from diart_tpu.core import annotation as jax_annotation
from diart_tpu.core import segment as jax_segment
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu.parallel import MultiStreamSession as JaxMultiStreamSession
from diart_tpu_torch import (
    EmbeddingModel,
    MultiStreamEngine,
    MultiStreamSession,
    SegmentationModel,
    audio,
    blocks,
    features,
    metrics,
    native,
    utils,
)
from diart_tpu_torch.core import annotation, segment

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4,
                 tau_active=0.45, rho_update=0.05)
TAU = 0.45
jax_mapping = importlib.import_module("diart_tpu.blocks.mapping")
port_mapping = importlib.import_module("diart_tpu_torch.blocks.mapping")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    jemb = JaxEmbeddingModel.from_registry("tpu/xvector", init_samples=8000, **EMB_KW).load()
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb), **EMB_KW)
    return (jseg, jemb), (pseg, pemb)


# --------------------------------------------------------------------- #
# blocks/mapping.py
# --------------------------------------------------------------------- #
def _maps(rng, builder):
    scores1 = rng.uniform(0, 1, (50, 4))
    scores2 = rng.uniform(0, 1, (50, 6))
    emb1, emb2 = rng.normal(size=(4, 8)), rng.normal(size=(6, 8))
    return {
        "correlation": builder.correlation(scores1, scores2),
        "mse": builder.mse(scores1, scores2),
        "mae": builder.mae(scores1, scores2),
        "cosine": builder.dist(emb1, emb2),
        "euclidean": builder.dist(emb1, emb2, "euclidean"),
        "cityblock": builder.dist(emb1, emb2, "cityblock"),
        "hard": builder.hard_map((4, 6), [(0, 2), (3, 1)], maximize=False),
        "hard_max": builder.hard_map((4, 6), [(1, 5)], maximize=True),
    }


def _map_view(m, scores):
    return (m.matrix, m.maximize, m.best_value, m.valid_assignments(), m.valid_assignments(strict=True),
            m.to_dict(), len(m), m.apply(scores),
            [m.is_source_speaker_mapped(s) for s in range(m.num_source_speakers)],
            [m.is_target_speaker_mapped(t) for t in range(m.num_target_speakers)])


def _same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speaker_map_builder_matches_jax(seed):
    """Every builder and every edit (unmap, threshold, compose, union, set,
    apply) gives the JAX package's matrices and assignments."""
    got = _maps(np.random.default_rng(seed), port_mapping.SpeakerMapBuilder)
    want = _maps(np.random.default_rng(seed), jax_mapping.SpeakerMapBuilder)
    scores = np.random.default_rng(seed + 10).uniform(0, 1, (7, 4))
    for name in got:
        g, w = got[name], want[name]
        _same(_map_view(g, scores), _map_view(w, scores))
        thr = float(np.median(g.matrix))
        _same(_map_view(g.unmap_threshold(thr), scores), _map_view(w.unmap_threshold(thr), scores))
        _same(_map_view(g.unmap_speakers([1], [0, 2]), scores),
              _map_view(w.unmap_speakers([1], [0, 2]), scores))
        _same(_map_view(g.set_source_speaker(2, 3), scores), _map_view(w.set_source_speaker(2, 3), scores))
        _same(_map_view(g.unmap_source_speaker(0), scores), _map_view(w.unmap_source_speaker(0), scores))
    _same(_map_view(got["mse"].union(got["hard"]), scores), _map_view(want["mse"].union(want["hard"]), scores))
    _same(_map_view(got["hard"] + got["mae"], scores), _map_view(want["hard"] + want["mae"], scores))
    sq = lambda mod: mod.SpeakerMapBuilder.hard_map((6, 5), [(0, 4), (2, 1)], maximize=True)
    _same(_map_view(got["correlation"].compose(sq(port_mapping)), scores),
          _map_view(want["correlation"].compose(sq(jax_mapping)), scores))


def test_speaker_map_fixes_carry_over():
    """The three mapping fixes of the JAX package: ``unmap_speakers`` takes
    numpy arrays (a single falsy element too), an explicit ``best_value``
    of 0.0 is written, and a zero-norm embedding has NaN cosine
    distances."""
    matrix = np.arange(12, dtype=float).reshape(3, 4)
    m = port_mapping.SpeakerMap(matrix)
    unmapped = m.unmap_speakers(np.array([0]), np.array([3]))
    assert (unmapped.matrix[0] == unmapped.invalid_value).all()
    assert (unmapped.matrix[:, 3] == unmapped.invalid_value).all()
    np.testing.assert_array_equal(unmapped.matrix, jax_mapping.SpeakerMap(matrix).unmap_speakers(
        np.array([0]), np.array([3])).matrix)
    forced = port_mapping.SpeakerMap(matrix, maximize=True, best_value=0.0).set_source_speaker(1, 2)
    assert forced.matrix[1, 2] == 0.0 and forced.best_value == 0.0
    assert port_mapping.MaximizationObjective(0.0).hard_speaker_map(2, 2, [(0, 1)]).best_value == 0.0
    emb = np.ones((2, 3))
    emb[1] = 0.0
    dist = port_mapping.SpeakerMapBuilder.dist(emb, np.ones((2, 3))).matrix
    assert np.isnan(dist[1]).all() and not np.isnan(dist[0]).any()


# --------------------------------------------------------------------- #
# blocks/clustering.py and blocks/aggregation.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_online_clustering_matches_jax(seed):
    """The host clustering oracle over a seeded chunk sequence: the same
    permuted scores, centres and active / blocked sets after every chunk
    (a NaN embedding and a full centre table included)."""
    rng = np.random.default_rng(seed)
    port = blocks.OnlineSpeakerClustering(0.5, 0.3, 0.6, max_speakers=4)
    ref = jax_blocks.OnlineSpeakerClustering(0.5, 0.3, 0.6, max_speakers=4)
    for chunk in range(14):
        seg = rng.uniform(0, 1, (40, 3)) ** 2
        emb = rng.normal(size=(3, 6))
        if chunk == 4:
            emb[1] = np.nan
        win = dict(start=0.5 * chunk, duration=0.05, step=0.05)
        got = port(segment.SlidingWindowFeature(seg, segment.SlidingWindow(**win)), emb)
        want = ref(jax_segment.SlidingWindowFeature(seg, jax_segment.SlidingWindow(**win)), emb)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(port.centers, ref.centers)
        assert port.active_centers == ref.active_centers
        assert port.blocked_centers == ref.blocked_centers
    assert port.num_free_centers == 0


@pytest.mark.parametrize("latency", ["step", 1.0, "duration"])
@pytest.mark.parametrize("cropping", ["loose", "strict", "center"])
@pytest.mark.parametrize("strategy", ["hamming", "mean", "first"])
def test_delayed_aggregation_matches_jax(strategy, cropping, latency):
    """Every strategy x cropping mode x latency over a rolling buffer, the
    first chunk's prepend included: the same frames and the same window."""
    duration, step, frames = 5.0, 0.5, 293
    lat = {"step": step, "duration": duration}.get(latency, latency)
    port = blocks.DelayedAggregation(step, lat, strategy, cropping)
    ref = jax_blocks.DelayedAggregation(step, lat, strategy, cropping)
    assert port.num_overlapping_windows == ref.num_overlapping_windows
    rng = np.random.default_rng(3)
    got_buf, want_buf = [], []
    for t in range(port.num_overlapping_windows + 4):
        chunk = rng.uniform(0, 1, (frames, 3)).astype(np.float32)
        win = dict(start=t * step, duration=duration / frames, step=duration / frames)
        got_buf = (got_buf + [segment.SlidingWindowFeature(chunk, segment.SlidingWindow(**win))])[
            -port.num_overlapping_windows:]
        want_buf = (want_buf + [jax_segment.SlidingWindowFeature(chunk, jax_segment.SlidingWindow(**win))])[
            -ref.num_overlapping_windows:]
        got, want = port(got_buf), ref(want_buf)
        np.testing.assert_array_equal(got.data, want.data, err_msg=f"t={t}")
        gw, ww = got.sliding_window, want.sliding_window
        assert (gw.start, gw.duration, gw.step) == (ww.start, ww.duration, ww.step)


# --------------------------------------------------------------------- #
# metrics/der.py
# --------------------------------------------------------------------- #
def _annotations(rng, labels, n, uri):
    pair = []
    for mod in (annotation, jax_annotation):
        seg_mod = segment if mod is annotation else jax_segment
        ann = mod.Annotation(uri=uri)
        local = np.random.default_rng(rng)
        for track in range(n):
            start = float(np.round(local.uniform(0, 30), 2))
            end = float(np.round(start + local.uniform(0.1, 5), 2))
            ann[seg_mod.Segment(start, end), track] = labels[local.integers(len(labels))]
        pair.append(ann)
    return pair


@pytest.mark.parametrize("collar,skip_overlap", [(0.0, False), (0.5, False), (0.0, True), (0.25, True)])
def test_der_and_deter_match_jax(collar, skip_overlap):
    """DER and DetER (components, per-file values, the accumulated total)
    on random annotations within 1e-12 of the JAX package's, and the same
    report."""
    ders = (metrics.DiarizationErrorRate(collar, skip_overlap),
            jax_metrics.DiarizationErrorRate(collar, skip_overlap))
    deters = (metrics.DetectionErrorRate(collar, skip_overlap),
              jax_metrics.DetectionErrorRate(collar, skip_overlap))
    for k in range(4):
        ref_p, ref_j = _annotations(100 + k, ["a", "b", "c"], 12, f"f{k}")
        hyp_p, hyp_j = _annotations(200 + k, ["s0", "s1", "s2", "s3"], 14, f"f{k}")
        for port, jaxm in (ders, deters):
            got = port(ref_p, hyp_p, detailed=True)
            want = jaxm(ref_j, hyp_j, detailed=True)
            assert got.keys() == want.keys()
            for key in got:
                assert abs(got[key] - want[key]) <= 1e-12, key
    for port, jaxm in (ders, deters):
        assert abs(abs(port) - abs(jaxm)) <= 1e-12
        assert 0.0 < abs(port) < 2.0
        got, want = port.report(), jaxm.report()
        assert list(got.columns) == list(want.columns) and list(got.index) == list(want.index)
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=1e-10)
    ref_p, _ = _annotations(7, ["a", "b"], 5, "same")
    assert metrics.DiarizationErrorRate()(ref_p, ref_p) == 0.0


def test_pipeline_api_imports_without_jax_or_pandas():
    """``diart_tpu_torch.blocks`` and ``.metrics`` import with jax,
    diart_tpu and pandas blocked; only ``report()`` needs pandas."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['diart_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import diart_tpu_torch.blocks, diart_tpu_torch.metrics\n"
        "import diart_tpu_torch.audio, diart_tpu_torch.features, diart_tpu_torch.utils\n"
        "from diart_tpu_torch import SpeakerDiarization, VoiceActivityDetection\n"
        "assert SpeakerDiarization.suggest_metric().name == 'diarization error rate'\n"
        "metric = VoiceActivityDetection.suggest_metric()\n"
        "try:\n"
        "    metric.report()\n"
        "except ImportError:\n"
        "    print('report needs pandas')\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'diart_tpu.', 'pandas'))\n"
        "            and sys.modules[m] is not None]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "report needs pandas"


# --------------------------------------------------------------------- #
# utils.py, audio.py, native/wavio.cpp, ops/resample.py
# --------------------------------------------------------------------- #
def test_padding_and_codecs_match_jax():
    for stream, chunk in ((1.0, 5.0), (5.0, 5.0), (7.5, 5.0), (0.0, 2.0)):
        assert utils.get_padding_left(stream, chunk) == jax_utils.get_padding_left(stream, chunk)
    for latency, step in ((0.5, 0.5), (2.0, 0.5), (5.0, 0.25)):
        assert utils.get_padding_right(latency, step) == jax_utils.get_padding_right(latency, step)
    rng = np.random.default_rng(4)
    wave = rng.uniform(-1.2, 1.2, 1000).astype(np.float32)
    for fn in ("encode_audio", "encode_audio_int16"):
        assert getattr(utils, fn)(wave) == getattr(jax_utils, fn)(wave)
    pcm = (wave * 3000).astype(np.int16)
    assert utils.encode_audio_int16(pcm) == jax_utils.encode_audio_int16(pcm)
    text = utils.encode_audio(wave)
    np.testing.assert_array_equal(utils.decode_audio(text), jax_utils.decode_audio(text))
    text16 = utils.encode_audio_int16(wave)
    np.testing.assert_array_equal(utils.decode_audio_int16(text16), jax_utils.decode_audio_int16(text16))
    assert utils.decode_audio(text).shape == (1, 1000)
    assert list(zip(range(3), utils.repeat_label("speech"))) == [(0, "speech"), (1, "speech"), (2, "speech")]
    for arg in (True, "false", "TRUE", "hf_token"):
        assert utils.parse_hf_token_arg(arg) == jax_utils.parse_hf_token_arg(arg)
    assert utils.get_pipeline_class("SpeakerDiarization") is blocks.SpeakerDiarization
    assert utils.get_pipeline_class("VoiceActivityDetection") is blocks.VoiceActivityDetection


def _write_wav(path, data: np.ndarray, rate: int, bits: int, fmt: int = 1):
    """(channels, samples) integer samples (or floats for fmt 3) -> a RIFF
    WAV of the given sample width and format code."""
    channels = data.shape[0]
    inter = data.T.reshape(-1)
    if fmt == 3:
        raw = inter.astype("<f8" if bits == 64 else "<f4").tobytes()
    elif bits == 8:
        raw = inter.astype(np.uint8).tobytes()
    elif bits == 24:
        v = inter.astype(np.int64) & 0xFFFFFF
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8).tobytes()
    else:
        raw = inter.astype({16: "<i2", 32: "<i4"}[bits]).tobytes()
    block = channels * bits // 8
    header = struct.pack("<4sI4s", b"RIFF", 36 + len(raw), b"WAVE")
    header += struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt, channels, rate, rate * block, block, bits)
    header += struct.pack("<4sI", b"data", len(raw))
    path.write_bytes(header + raw)
    return path


def _pcm(rng, bits, shape):
    if bits == 8:
        return rng.integers(0, 256, shape)
    top = 1 << (bits - 1)
    return rng.integers(-top, top, shape)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_wav_decoding_matches_jax(tmp_path, bits, channels):
    """``read_wav`` (numpy), ``AudioLoader.load`` (the native mono route)
    and ``get_duration`` equal the JAX package's on PCM of every width."""
    rng = np.random.default_rng(bits + channels)
    path = _write_wav(tmp_path / "x.wav", _pcm(rng, bits, (channels, 4001)), 16000, bits)
    got, rate = audio.read_wav(path)
    want, want_rate = jax_audio.read_wav(path)
    assert rate == want_rate == 16000 and got.shape == (channels, 4001)
    np.testing.assert_array_equal(got, want)
    loaded = audio.AudioLoader(16000).load(path)
    np.testing.assert_array_equal(loaded, jax_audio.AudioLoader(16000).load(path))
    assert native.wav_probe(path) == (16000, 4001, channels)
    np.testing.assert_allclose(loaded, got.mean(axis=0, keepdims=True), atol=1e-6)
    assert audio.AudioLoader(16000).get_duration(path) == jax_audio.AudioLoader(16000).get_duration(path)
    stereo = audio.AudioLoader(16000, mono=False).load(path)
    np.testing.assert_array_equal(stereo, jax_audio.AudioLoader(16000, mono=False).load(path))
    with audio.WavBlockReader(path) as reader, jax_audio.WavBlockReader(path) as ref:
        for _ in range(3):
            np.testing.assert_array_equal(reader.read_block(1500), ref.read_block(1500))


def test_write_wav_and_resampled_load_match_jax(tmp_path):
    """``write_wav`` writes the JAX package's bytes; a file at 8 kHz loads
    resampled to 16 kHz within 1e-5 of the JAX package's."""
    rng = np.random.default_rng(8)
    wave = rng.uniform(-0.9, 0.9, (2, 8000)).astype(np.float32)
    audio.write_wav(tmp_path / "p.wav", wave, 8000)
    jax_audio.write_wav(tmp_path / "j.wav", wave, 8000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got = audio.AudioLoader(16000).load(tmp_path / "p.wav")
    want = jax_audio.AudioLoader(16000).load(tmp_path / "p.wav")
    assert got.shape == want.shape == (1, 16000) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert audio.AudioLoader(16000).get_duration(tmp_path / "p.wav") == 1.0


def test_loader_reads_a_file_the_native_decoder_declines(tmp_path):
    """A 64-bit float WAV: the native decoder declines it (``wav_probe`` is
    None), and ``AudioLoader`` decodes it with numpy, as the JAX package
    does."""
    rng = np.random.default_rng(6)
    data = rng.uniform(-1, 1, (2, 3000))
    path = _write_wav(tmp_path / "f64.wav", data, 16000, 64, fmt=3)
    assert native.wav_probe(path) is None and native.wav_decode_mono(path) is None
    got = audio.AudioLoader(16000).load(path)
    np.testing.assert_array_equal(got, jax_audio.AudioLoader(16000).load(path))
    np.testing.assert_allclose(got[0], data.mean(axis=0), atol=1e-6)


def test_wav_decoder_raises_without_compiler(monkeypatch, tmp_path):
    """No quiet fallback: where no compiler builds the WAV decoder, the
    loader raises instead of returning None."""
    monkeypatch.setattr(native, "_wav_lib", None)
    monkeypatch.setattr(native, "_WAV_LIB_PATH", tmp_path / "libwavio.so")
    monkeypatch.setattr(native, "COMPILERS", ("no-such-c++-compiler",))
    with pytest.raises(RuntimeError, match="cannot build the native WAV decoder"):
        native.wav_probe(tmp_path / "x.wav")


@pytest.mark.parametrize("orig,new", [(8000, 16000), (16000, 8000), (44100, 16000), (16000, 16000)])
def test_resample_block_matches_jax(orig, new):
    """The Resample block on every container kind within 1e-5 of the JAX
    package's; the caller's container comes back."""
    rng = np.random.default_rng(orig + new)
    wave = rng.uniform(-0.8, 0.8, (2, 4410, 1)).astype(np.float32)
    want = np.asarray(jax_blocks.Resample(orig, new)(wave))
    block = blocks.Resample(orig, new, device="cpu")
    got = block(wave)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got_t = block(torch.from_numpy(wave))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-5)
    swf = segment.SlidingWindowFeature(wave[0], segment.SlidingWindow(start=1.0, duration=1 / orig, step=1 / orig))
    got_s = block(swf)
    assert isinstance(got_s, segment.SlidingWindowFeature) and got_s.sliding_window.start == 1.0
    np.testing.assert_allclose(got_s.data, want[0], rtol=0, atol=1e-5)


def test_adjust_volume_matches_jax():
    """AdjustVolume within 1e-5 of the JAX package's, a digitally silent
    chunk and a clipping one included (silence passes through, finite)."""
    rng = np.random.default_rng(2)
    wave = rng.uniform(-0.3, 0.3, (3, 2000, 1)).astype(np.float32)
    wave[1] = 0.0
    wave[2, 5] = 1.5
    for db in (-20.0, 0.0, 12.0):
        want = np.asarray(jax_blocks.AdjustVolume(db)(wave))
        got = blocks.AdjustVolume(db, device="cpu")(wave)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1], 0.0)


def test_formatter_restores_each_container():
    fmt = features.TemporalFeatureFormatter()
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    cast = fmt.cast(x)
    assert cast.shape == (1, 6, 2) and cast.dtype == torch.float32
    assert isinstance(fmt.restore_type(cast), np.ndarray)
    t = torch.zeros(2, 6, 2, dtype=torch.float64)
    assert fmt.cast(t).dtype == torch.float32
    restored = fmt.restore_type(torch.ones(2, 6, 2))
    assert isinstance(restored, torch.Tensor) and restored.device == t.device
    swf = segment.SlidingWindowFeature(x, segment.SlidingWindow(start=2.0, duration=0.5, step=0.5))
    back = fmt.restore_type(fmt.cast(swf))
    assert isinstance(back, segment.SlidingWindowFeature) and back.sliding_window.start == 2.0
    assert back.sliding_window.duration == 0.5
    with pytest.raises(TypeError):
        fmt.cast([1.0, 2.0])


# --------------------------------------------------------------------- #
# model blocks
# --------------------------------------------------------------------- #
def _containers(data: np.ndarray, step: float):
    """The same (1, T, C) data as a SlidingWindowFeature, numpy and torch,
    in both packages' kinds."""
    kw = dict(start=0.5, duration=step, step=step)
    return {
        "swf": (segment.SlidingWindowFeature(data[0], segment.SlidingWindow(**kw)),
                jax_segment.SlidingWindowFeature(data[0], jax_segment.SlidingWindow(**kw))),
        "numpy": (data, data),
        "torch": (torch.from_numpy(data.copy()), torch.from_numpy(data.copy())),
    }


def _as_numpy(x):
    if isinstance(x, (segment.SlidingWindowFeature, jax_segment.SlidingWindowFeature)):
        return np.asarray(x.data)[None]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["swf", "numpy", "torch"])
def test_model_blocks_match_jax(models, kind):
    """SpeakerSegmentation and OverlapAwareSpeakerEmbedding on small
    registry models within 1e-4 of diart_tpu.blocks', each container kind
    restored as the JAX package restores it."""
    (jseg, jemb), (pseg, pemb) = models
    rng = np.random.default_rng(12)
    wave = rng.normal(scale=0.1, size=(1, 8000, 1)).astype(np.float32)
    port_wave, jax_wave = _containers(wave, 1 / 16000)[kind]
    seg_block, jax_seg_block = blocks.SpeakerSegmentation(pseg), jax_blocks.SpeakerSegmentation(jseg)
    got_seg, want_seg = seg_block(port_wave), jax_seg_block(jax_wave)
    assert type(got_seg).__name__ == type(want_seg).__name__
    if kind == "swf":
        assert got_seg.sliding_window.start == want_seg.sliding_window.start
        assert got_seg.sliding_window.duration == pytest.approx(want_seg.sliding_window.duration, abs=1e-15)
    np.testing.assert_allclose(_as_numpy(got_seg), _as_numpy(want_seg), rtol=0, atol=1e-4)
    emb_block = blocks.OverlapAwareSpeakerEmbedding(pemb, gamma=3.0, beta=10.0)
    jax_emb_block = jax_blocks.OverlapAwareSpeakerEmbedding(jemb, gamma=3.0, beta=10.0)
    got_emb, want_emb = emb_block(port_wave, got_seg), jax_emb_block(jax_wave, want_seg)
    assert isinstance(got_emb, torch.Tensor) and got_emb.shape == tuple(want_emb.shape) == (1, 3, 16)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), rtol=0, atol=1e-4)
    # the embedding alone: squeezed like diart's, with and without weights
    plain = blocks.SpeakerEmbedding(pemb)(port_wave)
    assert plain.shape == (16,)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jax_blocks.SpeakerEmbedding(jemb)(jax_wave)),
                               rtol=0, atol=1e-4)


def test_embedding_blocks_on_batches(models):
    """Batched waveforms, the model's diart-style call (weights (B, T)),
    the normalization block with a per-speaker norm, and the OSP block's
    normalized weights, against the JAX package."""
    (jseg, jemb), (pseg, pemb) = models
    rng = np.random.default_rng(13)
    wave = rng.normal(scale=0.1, size=(3, 8000, 1)).astype(np.float32)
    seg = rng.uniform(0, 1, (3, 29, 3)).astype(np.float32)
    osp = blocks.OverlappedSpeechPenalty(2.0, 5.0, normalize=True, device="cpu")(seg)
    np.testing.assert_allclose(osp, np.asarray(jax_blocks.OverlappedSpeechPenalty(2.0, 5.0, True)(seg)),
                               rtol=0, atol=1e-6)
    w = rng.uniform(0, 1, (3, 29)).astype(np.float32)
    got = pemb(torch.from_numpy(wave).transpose(1, 2), torch.from_numpy(w))
    want = np.asarray(jemb(np.swapaxes(wave, 1, 2), w))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    norm = rng.uniform(1, 2, (3, 1)).astype(np.float32)
    emb = rng.normal(size=(3, 3, 16)).astype(np.float32)
    got = blocks.EmbeddingNormalization(norm)(torch.from_numpy(emb))
    want = np.asarray(jax_blocks.EmbeddingNormalization(norm)(emb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # normalize_embeddings gives 2-D input its batch axis back
    assert blocks.EmbeddingNormalization(1.0)(torch.from_numpy(emb[0])).shape == (1, 3, 16)


def test_model_device_rules(models):
    """Blocks run where their model is: another device raises; pyannote
    names need pyannote.audio (an optional dependency) and say so."""
    _, (pseg, pemb) = models
    with pytest.raises(ValueError, match="models are on cpu"):
        blocks.SpeakerSegmentation(pseg, device="cuda")
    with pytest.raises(ValueError, match="models are on cpu"):
        blocks.OverlapAwareSpeakerEmbedding(pemb, device="cuda")
    assert blocks.SpeakerEmbedding(pemb, device="cpu").device.type == "cpu"
    for model_cls in (SegmentationModel, EmbeddingModel):
        with pytest.raises(ImportError, match="pyannote.audio"):
            model_cls.from_pretrained("pyannote/segmentation", device="cpu")
    assert SegmentationModel.from_pretrained("tpu/pyannet", device="cpu", **SEG_KW).num_speakers == 3


# --------------------------------------------------------------------- #
# the two session repairs
# --------------------------------------------------------------------- #
def _session_blocks(seed=31, hops=8, batch=2):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=(hops, batch, 4000)).astype(np.float32)


def test_quantize_transfer_quantizes_float_tensor_blocks(models):
    """A session fed float tensor blocks with ``quantize_transfer`` sends
    the int16 PCM a numpy-fed session sends: the same aggregated scores
    bit for bit, and RTTM text equal to diart_tpu's session fed the numpy
    blocks."""
    (jseg, jemb), (pseg, pemb) = models
    blocks_np = _session_blocks()
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, batch_size=2, **ENGINE_KW)
    jses = JaxMultiStreamSession(jeng, tau_active=TAU, collect_audio=False, quantize_transfer=True)
    want = [jses.push_rttm(blk) for blk in blocks_np]
    runs = {}
    for route in ("numpy", "tensor"):
        engine = MultiStreamEngine(pseg, pemb, batch_size=2, **ENGINE_KW)
        session = MultiStreamSession(engine, tau_active=TAU, collect_audio=False, quantize_transfer=True)
        texts, scores = [], []
        for blk in blocks_np:
            pending = session.push_begin(blk if route == "numpy" else torch.from_numpy(blk))
            if pending is None:
                texts.append([None, None])
                continue
            scores.append(pending.device_aggregated.clone())
            texts.append(session.push_finish_rttm(pending))
        runs[route] = (texts, torch.stack(scores))
    assert torch.equal(runs["tensor"][1], runs["numpy"][1])
    assert runs["tensor"][0] == runs["numpy"][0] == want
    assert any(t for hop in want for t in hop)
    q = MultiStreamSession._quantize(torch.tensor([0.5, -1.5, 2.0, -0.99999, 3.1e-5]))
    assert q.dtype == torch.int16 and q.tolist() == [16384, -32768, 32767, -32767, 1]
    assert MultiStreamSession._quantize(torch.tensor([3], dtype=torch.int16)).tolist() == [3]


def test_collect_audio_takes_tensor_blocks(models):
    """``collect_audio`` with tensor blocks gives the numpy-fed session's
    annotations and audio regions (the card's case runs in chip_smoke.py)."""
    _, (pseg, pemb) = models
    blocks_np = _session_blocks(seed=32)
    runs = {}
    for route in ("numpy", "tensor"):
        engine = MultiStreamEngine(pseg, pemb, batch_size=2, **ENGINE_KW)
        session = MultiStreamSession(engine, tau_active=TAU, collect_audio=True)
        outs = []
        for k, blk in enumerate(blocks_np):
            present = np.array([True, k != 4])
            outs.append(session.push(blk if route == "numpy" else torch.from_numpy(blk), present))
        runs[route] = outs
    emitted = 0
    for got_hop, want_hop in zip(runs["tensor"], runs["numpy"]):
        for got, want in zip(got_hop, want_hop):
            assert (got is None) == (want is None)
            if got is None:
                continue
            emitted += 1
            assert got[0].to_rttm() == want[0].to_rttm()
            np.testing.assert_array_equal(got[1].data, want[1].data)
            assert got[1].sliding_window.start == want[1].sliding_window.start
    assert emitted > 8
