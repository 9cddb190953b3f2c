"""Parity of the port's model families with diart_tpu, on the CPU.

The three mel families this slice adds (``tpu/resnet34`` with the kaldi
frontend, ``tpu/titanet`` with the nemo frontend, ``tpu/xvect-sb`` with
the speechbrain frontend at 24 mels) and the powerset PyanNet
(``tpu/pyannet-powerset``), at the widths of
``tests/test_engine_families.py`` (the powerset model H=16, 1 layer):
features, trunk and head against the flax models on weights carried by
``load_flax_params``; the kaldi and nemo frontends and ring pieces; the
powerset decode, the engine against the pipeline and VAD (the cases of
``tests/test_engine_powerset.py``);
and the pipelines' host-only (ONNX-contract) routes (the cases of
``tests/test_onnx_fallback.py``) on torch fakes. Inputs come from numpy
seeds; the port runs its kernels' plain versions (CPU tensors), the JAX
side its portable paths, as its own CPU tests do. The engines of both
packages are held together in ``tests/test_torch_families_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diart_tpu import SpeakerDiarization as JaxSpeakerDiarization
from diart_tpu import SpeakerDiarizationConfig as JaxSpeakerDiarizationConfig
from diart_tpu import VoiceActivityDetection as JaxVoiceActivityDetection
from diart_tpu import VoiceActivityDetectionConfig as JaxVoiceActivityDetectionConfig
from diart_tpu import precision as jax_precision
from diart_tpu.core.segment import SlidingWindow as JaxSlidingWindow
from diart_tpu.core.segment import SlidingWindowFeature as JaxSlidingWindowFeature
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.models import base as jax_base
from diart_tpu.models import fbank as jax_fbank
from diart_tpu.models import powerset as jax_powerset
from diart_tpu_torch import (
    EmbeddingModel,
    MultiStreamEngine,
    MultiStreamSession,
    SegmentationModel,
    SpeakerDiarization,
    SpeakerDiarizationConfig,
    VoiceActivityDetection,
    VoiceActivityDetectionConfig,
)
from diart_tpu_torch.core.segment import SlidingWindow, SlidingWindowFeature
from diart_tpu_torch.metrics import DiarizationErrorRate
from diart_tpu_torch.models import fbank, powerset
from diart_tpu_torch.runtime.sinks import PredictionAccumulator

import fakes
from fakes import SAMPLE_RATE, Turn, synth_audio
from golden_config import GOLDEN_TURNS, TOTAL
from test_torch_pipeline import fake_embedding, fake_segmentation

DURATION, STEP = 2.0, 0.5
FAMILIES = {
    "tpu/resnet34": dict(embedding_dim=32, base_channels=8),
    "tpu/titanet": dict(embedding_dim=32, channels=32),
    "tpu/xvect-sb": dict(
        embedding_dim=32,
        tdnn_specs=((5, 1, 16), (3, 2, 16), (3, 3, 16), (1, 1, 16), (1, 1, 48)),
    ),
}
KINDS = {"tpu/resnet34": "kaldi", "tpu/titanet": "nemo", "tpu/xvect-sb": "speechbrain"}
SEG_KW = dict(num_speakers=3, lstm_hidden=16, lstm_layers=1, linear_dims=(16,))
PS_KW = dict(num_speakers=3, max_simultaneous=2, lstm_hidden=16, lstm_layers=1, linear_dims=(16,))
ENGINE_KW = dict(duration=DURATION, step=STEP, latency=STEP, sample_rate=SAMPLE_RATE, max_speakers=4,
                 batch_size=3, tau_active=0.45, rho_update=0.05)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(model):
    return jax.tree_util.tree_map(np.asarray, model.params)


def _jit_init(module, seed: int, samples: int):
    """The JAX registry's ``_init_params`` as one compiled program (op by
    op it takes ~10x longer on the CPU); the same portable policy."""
    with jax_precision.use(jax_precision.Precision.portable(), force=True):
        return jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 1, samples)))


def jax_registry(cls, name, **kwargs):
    """``cls.from_registry(name, **kwargs)`` of the JAX package, loaded,
    its init compiled as one program."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base, "_init_params", _jit_init)
        return cls.from_registry(name, **kwargs).load()


def family_pairs_of(names):
    """{name: (JAX registry model, the port's registry model on its flax
    tree)} for the FAMILIES ``names``."""
    out = {}
    for name in names:
        kw = FAMILIES[name]
        jemb = jax_registry(JaxEmbeddingModel, name, init_samples=8000, **kw)
        out[name] = (jemb, EmbeddingModel.from_registry(name, device="cpu", flax_params=_tree(jemb), **kw))
    return out


@pytest.fixture(scope="module")
def family_pairs():
    return family_pairs_of(sorted(FAMILIES))


# ----------------------------------------------------------------------- #
# frontends


@pytest.mark.parametrize("kind", ["kaldi", "nemo"])
def test_direct_frontend_matches_jax(kind):
    """Both sides build the bases and mel matrices in float64 numpy (equal
    bit for bit) and run the DFT in true f32; the natural-log features of
    low-energy bins carry the f32 cancellation of the DFT sums: atol 1e-4."""
    mats = {"kaldi": ("kaldi_mel_matrix", (80, 512, SAMPLE_RATE)),
            "nemo": ("librosa_mel_matrix", (80, 512, SAMPLE_RATE))}
    name, args = mats[kind]
    np.testing.assert_array_equal(getattr(fbank, name)(*args), getattr(jax_fbank, name)(*args))
    wave = np.random.default_rng(1).normal(scale=0.1, size=(2, 12345)).astype(np.float32)
    fn = f"{kind}_log_mel"
    want = np.asarray(getattr(jax_fbank, fn)(jnp.asarray(wave)))
    got = getattr(fbank, fn)(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("chunk,step", [(32000, 8000), (80000, 8000)])
@pytest.mark.parametrize("kind", ["kaldi", "speechbrain", "nemo"])
def test_fbank_ring_spec_and_pieces_match_jax(kind, chunk, step):
    """The ring geometry equals JAX's (None included) for each kind at the
    2 s / 0.5 s and 5 s / 0.5 s geometries; the fill is equal and the
    block and edge frames within 1e-4 (natural log) / 1e-3 (dB)."""
    spec = fbank.fbank_ring_spec(kind, 80, SAMPLE_RATE, chunk, step)
    want_spec = jax_fbank.fbank_ring_spec(kind, 80, SAMPLE_RATE, chunk, step)
    assert tuple(spec) == tuple(want_spec)
    np.testing.assert_array_equal(fbank.fbank_ring_fill(spec), jax_fbank.fbank_ring_fill(want_spec))
    rng = np.random.default_rng(2)
    tail = rng.normal(scale=0.1, size=(2, spec.tail_len)).astype(np.float32)
    block = rng.normal(scale=0.1, size=(2, step)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    pairs = [(fbank.fbank_block_raw(spec, t(tail), t(block)), jax_fbank.fbank_block_raw(spec, tail, block))]
    if spec.edge:
        head = rng.normal(scale=0.1, size=(2, spec.head_len)).astype(np.float32)
        pairs += [(fbank.fbank_edge_left(spec, t(head)), jax_fbank.fbank_edge_left(spec, head)),
                  (fbank.fbank_edge_right(spec, t(tail)), jax_fbank.fbank_edge_right(spec, tail))]
    for got, want in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3 if kind == "speechbrain" else 1e-4)


@pytest.mark.parametrize("kind", ["kaldi", "speechbrain", "nemo", "mfcc"])
def test_fbank_ring_declines_where_jax_does(kind):
    """Over steps that the hop grid does or does not divide, chunks that the
    step does or does not divide, and edge contexts wider than a block, the
    port builds the ring exactly where JAX does and declines it (None, the
    engine then keeps the direct frontend) exactly where JAX does."""
    declined = 0
    for chunk in (6400, 32000, 80000):
        for step in (160, 320, 480, 1600, 4800, 8000, 8080):
            spec = fbank.fbank_ring_spec(kind, 80, SAMPLE_RATE, chunk, step)
            want = jax_fbank.fbank_ring_spec(kind, 80, SAMPLE_RATE, chunk, step)
            assert (spec is None) == (want is None), (chunk, step)
            assert spec is None or tuple(spec) == tuple(want), (chunk, step)
            declined += spec is None
    assert declined > 0


# ----------------------------------------------------------------------- #
# the families' modules


# f32 on both sides: features within 1e-4 (log-mels, the nemo/kaldi ones
# normalized), trunk outputs within 1e-4 x max(1, |trunk|), embeddings 1e-4
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax(family_pairs, name):
    jemb, pemb = family_pairs[name]
    assert pemb.fbank_ring_kind == KINDS[name]
    rng = np.random.default_rng(3)
    wave = rng.normal(scale=0.1, size=(2, 1, 16000)).astype(np.float32)
    want_f = np.asarray(jemb.module.apply(jemb.params, jnp.asarray(wave), method="features"))
    got_f = pemb.module.features(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got_f, want_f, atol=1e-4)
    want_t = np.asarray(jemb.trunk_fn()(jemb.params, jnp.asarray(wave)))
    extra = {"fused_head": False} if name == "tpu/xvect-sb" else {}
    with torch.no_grad():
        got_t = pemb.module.trunk(torch.from_numpy(wave), **extra).numpy()
    assert got_t.shape == want_t.shape
    np.testing.assert_allclose(got_t, want_t, atol=1e-4 * max(1.0, np.abs(want_t).max()))
    weights = rng.uniform(size=(2, 3, 40)).astype(np.float32)  # resampled to the trunk's frames
    want = np.asarray(jemb.head_fn()(jemb.params, jnp.asarray(want_t), jnp.asarray(weights)))
    if name == "tpu/xvect-sb":  # the port's fused split: the head takes the last TDNN
        got = pemb.head(pemb.trunk(torch.from_numpy(wave)), torch.from_numpy(weights)).numpy()
        assert pemb.trunk(torch.from_numpy(wave)).shape[-1] == 16
    else:
        got = pemb.head(torch.from_numpy(want_t), torch.from_numpy(weights)).numpy()
    assert got.shape == want.shape == (2, 3, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_bf16_trunk(family_pairs, name):
    """dtype="bf16" runs the trunk in bf16 (the head pools in f32); its
    embeddings stay within 0.05 of the f32 model's on unit-scale outputs."""
    jemb, pemb = family_pairs[name]
    bf = EmbeddingModel.from_registry(name, device="cpu", flax_params=_tree(jemb), dtype="bf16",
                                      **FAMILIES[name])
    wave = torch.from_numpy(np.random.default_rng(4).normal(scale=0.1, size=(1, 1, 16000)).astype(np.float32))
    frames = bf.trunk(wave)
    assert frames.dtype == torch.bfloat16
    got, want = bf.head(frames), pemb.head(pemb.trunk(wave))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05 * max(1.0, want.abs().max().item()))


def test_registry_names_and_arguments():
    for name, kw in FAMILIES.items():
        with pytest.raises(TypeError, match="unknown arguments"):
            EmbeddingModel.from_registry(name, device="cpu", lstm_hidden=8, **kw)
    with pytest.raises(ValueError, match="tpu/xvect-sb"):
        EmbeddingModel.from_registry("tpu/nope", device="cpu")
    with pytest.raises(TypeError, match="unknown arguments"):
        SegmentationModel.from_registry("tpu/pyannet", device="cpu", max_simultaneous=2)
    ps = SegmentationModel.from_registry("tpu/pyannet-powerset", device="cpu", seed=0,
                                         lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
    assert ps.powerset == (3, 2) and ps.num_speakers == 3 and ps.module.classifier.out_features == 7
    # --powerset is for torch checkpoints; a registry name ignores it, as in the JAX CLI
    plain = SegmentationModel.from_pretrained("tpu/pyannet", device="cpu", powerset=(3, 2), **SEG_KW)
    assert plain.powerset is None and plain.num_speakers == 3


# ----------------------------------------------------------------------- #
# powerset


def test_to_multilabel_matches_jax():
    """Hard decode equal (the smallest top-1 - top-2 margin is printed; a
    tie closer than the f32 error could pick another class), soft decode
    within 1e-6; the mapping equal bit for bit."""
    mapping = powerset.powerset_mapping(3, 2)
    np.testing.assert_array_equal(mapping, jax_powerset.powerset_mapping(3, 2))
    assert powerset.num_powerset_classes(4, 2) == jax_powerset.num_powerset_classes(4, 2) == 11
    scores = np.random.default_rng(6).normal(size=(4, 50, 7)).astype(np.float32)
    top2 = np.sort(scores, axis=-1)[..., -2:]
    print(f"min top-1 - top-2 margin: {float((top2[..., 1] - top2[..., 0]).min()):.3e}")
    for soft in (False, True):
        want = np.asarray(jax_powerset.to_multilabel(jnp.asarray(scores), mapping, soft=soft))
        got = powerset.to_multilabel(torch.from_numpy(scores), mapping, soft=soft).numpy()
        np.testing.assert_allclose(got, want, atol=0 if not soft else 1e-6)


@pytest.fixture(scope="module")
def powerset_pair():
    """The small powerset PyanNet of tests/test_engine_powerset.py, the
    empty-set class suppressed (bias -5), in both packages."""
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet-powerset", init_samples=int(DURATION * SAMPLE_RATE),
                        **PS_KW)
    bias = np.asarray(jseg.params["params"]["classifier"]["bias"]).copy()
    bias[0] = -5.0
    jseg.params["params"]["classifier"]["bias"] = jnp.asarray(bias)
    pseg = SegmentationModel.from_registry("tpu/pyannet-powerset", device="cpu", flax_params=_tree(jseg), **PS_KW)
    return jseg, pseg


PS_PARAMS = dict(duration=DURATION, step=STEP, latency=STEP, tau_active=0.6, rho_update=0.1, delta_new=0.7,
                 max_speakers=6, sample_rate=SAMPLE_RATE)


def test_powerset_engine_matches_pipeline(powerset_pair):
    """The engine and the host pipeline agree on the same powerset model
    (DER between their predictions < 0.02, as in the JAX test)."""
    _, seg = powerset_pair
    emb = fake_embedding()
    audio = synth_audio([Turn(0.0, 2.5, 0), Turn(3.5, 6.0, 1)], 8.0, seed=3)
    engine = MultiStreamEngine(seg, emb, batch_size=1, **PS_PARAMS)
    session = MultiStreamSession(engine, tau_active=PS_PARAMS["tau_active"], collect_audio=False)
    step_s = engine.step_samples
    engine_anns = []
    for blk in range(audio.shape[1] // step_s):
        out = session.push(audio[:, blk * step_s : (blk + 1) * step_s])
        if out[0] is not None:
            engine_anns.append(out[0][0])
    pipe = SpeakerDiarization(SpeakerDiarizationConfig(segmentation=seg, embedding=emb, **PS_PARAMS))
    chunk_s, res = int(DURATION * SAMPLE_RATE), 1.0 / SAMPLE_RATE
    pipe_anns = []
    for start in range(0, audio.shape[1] - chunk_s + 1, step_s):
        sw = SlidingWindow(start=start / SAMPLE_RATE, duration=res, step=res)
        pipe_anns.extend(a for a, _ in pipe([SlidingWindowFeature(audio[0, start : start + chunk_s, None], sw)]))
    assert len(pipe_anns) == len(engine_anns) > 0
    acc_p, acc_e = PredictionAccumulator("u"), PredictionAccumulator("u")
    for a in pipe_anns:
        acc_p.on_next(a)
    for a in engine_anns:
        acc_e.on_next(a)
    error = DiarizationErrorRate()(acc_p.get_prediction(), acc_e.get_prediction())
    assert error < 0.02, f"engine vs pipeline DER {error:.4f}"


def test_powerset_vad_engine_and_pipeline(powerset_pair):
    """VAD mode takes the max over decoded speakers: with the empty set
    suppressed every frame is speech, in the engine and in the
    VoiceActivityDetection pipeline (one "speech" label)."""
    _, seg = powerset_pair
    engine = MultiStreamEngine(seg, None, **PS_PARAMS)
    assert engine.num_local == 3
    state = engine.init_state(1)
    rng = np.random.default_rng(1)
    for i in range(5):
        blocks = rng.normal(scale=0.1, size=(1, engine.step_samples)).astype(np.float32)
        state, out = engine.step(state, blocks, run_mask=np.full((1,), i + 1 >= 4))
    assert out.newest.shape[-1] == 1 and bool((out.newest == 1.0).all())
    pipe = VoiceActivityDetection(VoiceActivityDetectionConfig(
        segmentation=seg, duration=DURATION, step=STEP, latency=STEP, tau_active=0.6, sample_rate=SAMPLE_RATE))
    audio = synth_audio([Turn(0.0, 4.0, 0)], 4.0, seed=0)
    sw = SlidingWindow(start=0.0, duration=1.0 / SAMPLE_RATE, step=1.0 / SAMPLE_RATE)
    outputs = pipe([SlidingWindowFeature(audio[0, : int(DURATION * SAMPLE_RATE), None], sw)])
    assert len(outputs) == 1 and outputs[0][0].labels() == ["speech"]


# ----------------------------------------------------------------------- #
# host-only (ONNX-contract) models through the pipelines


class _HostSeg:
    """The port's fake segmentation behind the ONNX wrapper's contract:
    numpy (N, ch, S) in, numpy (N, frames, K) out."""

    host_only = True

    def __init__(self):
        self._model = fake_segmentation()
        self.num_speakers = self._model.num_speakers

    def __call__(self, wave):
        return self._model(torch.from_numpy(np.asarray(wave))).numpy()


class _HostEmb:
    """The port's fake embedding behind the ONNX wrapper's contract:
    (N*K, ch, S) and (N*K, T) in, (N*K, E) out."""

    host_only = True

    def __init__(self):
        self._model = fake_embedding()
        self.embedding_dim = self._model.embedding_dim

    def __call__(self, wave, weights):
        return self._model(torch.from_numpy(np.asarray(wave)), torch.from_numpy(np.asarray(weights))).numpy()


def _host_models():
    return SegmentationModel(_HostSeg(), "host", "cpu"), EmbeddingModel(_HostEmb(), "host", "cpu")


HOST_PIPE = dict(duration=DURATION, step=STEP, latency=STEP, tau_active=0.6, rho_update=0.1, delta_new=0.7,
                 max_speakers=8, sample_rate=SAMPLE_RATE)


def _texts(pipeline, audio, window_cls, feature_cls):
    chunk, hop, res = int(DURATION * SAMPLE_RATE), int(STEP * SAMPLE_RATE), 1.0 / SAMPLE_RATE
    texts = []
    for start in range(0, audio.shape[1] - chunk + 1, hop):
        sw = window_cls(start=start / SAMPLE_RATE, duration=res, step=res)
        texts.extend(a.to_rttm() for a, _ in pipeline([feature_cls(audio[0, start : start + chunk, None], sw)]))
    return "".join(texts)


@pytest.mark.parametrize("case", ["host_both", "host_embedding", "vad"])
def test_host_only_pipelines_match(case):
    """A host-only segmentation and/or embedding model through the port's
    pipelines gives the RTTM text of the same fakes on the device route,
    and of diart_tpu's pipeline on its fakes."""
    audio = synth_audio(GOLDEN_TURNS, TOTAL)
    host_seg, host_emb = _host_models()
    if case == "vad":
        kw = {k: HOST_PIPE[k] for k in ("duration", "step", "latency", "tau_active", "sample_rate")}
        host = VoiceActivityDetection(VoiceActivityDetectionConfig(segmentation=host_seg, **kw))
        device = VoiceActivityDetection(VoiceActivityDetectionConfig(segmentation=fake_segmentation(), **kw))
        jax_pipe = JaxVoiceActivityDetection(JaxVoiceActivityDetectionConfig(
            segmentation=fakes.fake_segmentation(), **kw))
    else:
        seg = host_seg if case == "host_both" else fake_segmentation()
        host = SpeakerDiarization(SpeakerDiarizationConfig(segmentation=seg, embedding=host_emb, **HOST_PIPE))
        device = SpeakerDiarization(SpeakerDiarizationConfig(
            segmentation=fake_segmentation(), embedding=fake_embedding(), **HOST_PIPE))
        jax_pipe = JaxSpeakerDiarization(JaxSpeakerDiarizationConfig(
            segmentation=fakes.fake_segmentation(), embedding=fakes.fake_embedding(), **HOST_PIPE))
    got = _texts(host, audio, SlidingWindow, SlidingWindowFeature)
    assert got == _texts(device, audio, SlidingWindow, SlidingWindowFeature)
    assert got == _texts(jax_pipe, audio, JaxSlidingWindow, JaxSlidingWindowFeature)
    assert ("speech" if case == "vad" else "SPEAKER") in got


def test_host_embedding_dim_found_at_first_call():
    """A host embedding model that does not state its dimension (512
    assumed) gets its clustering state rebuilt at the first call."""
    host_seg, host_emb = _host_models()
    del host_emb.module.embedding_dim
    assert host_emb.embedding_dim == 512
    pipe = SpeakerDiarization(SpeakerDiarizationConfig(segmentation=host_seg, embedding=host_emb, **HOST_PIPE))
    audio = synth_audio(GOLDEN_TURNS, TOTAL)
    sw = SlidingWindow(start=0.0, duration=1.0 / SAMPLE_RATE, step=1.0 / SAMPLE_RATE)
    pipe([SlidingWindowFeature(audio[0, : int(DURATION * SAMPLE_RATE), None], sw)])
    assert pipe.clustering_state.centers.shape[-1] == fake_embedding().embedding_dim


def test_engine_rejects_host_models():
    host_seg, host_emb = _host_models()
    with pytest.raises(RuntimeError, match="pipeline path"):
        MultiStreamEngine(host_seg, None, duration=1.0, step=0.5, latency=0.5, sample_rate=SAMPLE_RATE)
    with pytest.raises(RuntimeError, match="pipeline path"):
        MultiStreamEngine(fake_segmentation(), host_emb, duration=1.0, step=0.5, latency=0.5,
                          sample_rate=SAMPLE_RATE)


def test_onnx_needs_onnxruntime(tmp_path):
    """The ONNX route is a raising stub where onnxruntime (an optional
    dependency) is missing."""
    try:
        import onnxruntime  # noqa: F401

        pytest.skip("onnxruntime is installed")
    except ImportError:
        pass
    for cls in (SegmentationModel, EmbeddingModel):
        with pytest.raises(ImportError, match="onnxruntime"):
            cls.from_pretrained(str(tmp_path / "model.onnx"))
