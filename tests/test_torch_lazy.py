"""Lazy models and the per-family checkpoint loaders of the port
(``models/base.py`` ``LazyModel``, ``models/convert.py``), on the CPU.

* The ``from_*`` constructors store a loader: nothing is built until first
  use, as diart_tpu's ``LazyModel``; ``load``, ``to``, ``eval`` and
  ``with_dtype`` behave as its; a lazy model's outputs are bitwise an
  eager model's of the same weights; a pickled model carries its loader
  and no tensor, and rebuilds the same weights.
* ``Parallelize`` with lazy models (spawn workers rebuild them from their
  loaders) reproduces a committed golden fixture's text.
* The five public loaders (``load_ecapa_checkpoint`` ...) give exactly
  diart_tpu's parameters on the ``tests/torch_replicas.py`` checkpoints,
  once carried into the port's modules.
"""

import io
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.models import convert as jax_convert
from diart_tpu_torch import models
from diart_tpu_torch.audio import write_wav
from diart_tpu_torch.blocks import SpeakerDiarization, SpeakerDiarizationConfig
from diart_tpu_torch.metrics import DiarizationErrorRate
from diart_tpu_torch.models import EmbeddingModel, LazyModel, SegmentationModel, convert
from diart_tpu_torch.runtime import Benchmark, Parallelize
from diart_tpu_torch.weights import flax_params

import golden_config
from fakes import SAMPLE_RATE, synth_audio
from test_torch_pipeline import SPEAKER_FREQS, TONE_AMPLITUDE, _band_amplitudes
from torch_replicas import NMTitaNet, SBEcapaTDNN, SBXVector, TorchXVectorSincNet, WSResNet34

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
GOLDEN_DIR = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lazy():
    return (SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=0, **SEG_KW),
            EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, **EMB_KW))


def _wave(batch=2, samples=16000, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).normal(scale=0.1, size=(batch, 1, samples))
                            .astype(np.float32))


class _TensorSpy(pickle.Pickler):
    """A pickler that records every tensor it is handed."""

    def __init__(self, file):
        super().__init__(file)
        self.tensors = 0

    def reducer_override(self, obj):
        if isinstance(obj, (torch.Tensor, torch.UntypedStorage, torch.TypedStorage)):
            self.tensors += 1
        return NotImplemented


def _tensors_in_pickle(obj) -> int:
    buf = io.BytesIO()
    spy = _TensorSpy(buf)
    spy.dump(obj)
    return spy.tensors


def test_from_registry_builds_nothing_until_first_use():
    """Both packages: a registry model is not in memory after the
    constructor; a property loads it; ``load`` returns the model itself."""
    seg, emb = _lazy()
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", **SEG_KW)
    assert isinstance(seg, LazyModel) and isinstance(emb, LazyModel)
    assert not seg.is_in_memory() and not emb.is_in_memory() and not jseg.is_in_memory()
    assert seg.device == torch.device("cpu") and not seg.is_in_memory()  # the device needs no load
    assert seg.num_speakers == 3 and seg.is_in_memory()
    assert emb.load() is emb and emb.is_in_memory() and emb.module.embedding_dim == 16
    assert jseg.load() is jseg and jseg.is_in_memory()


@pytest.mark.parametrize("route", ["registry", "pretrained", "file", "torch", "apply"])
def test_every_route_is_lazy(tmp_path, route):
    """``from_registry``, ``from_pretrained`` (registry name, model file,
    torch checkpoint) and ``from_apply`` return models that are not in
    memory; a file's or checkpoint's route has read and checked its
    source already (a bad one raises there, as before)."""
    if route == "registry":
        model = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, **EMB_KW)
    elif route == "pretrained":
        model = EmbeddingModel.from_pretrained("tpu/xvector", device="cpu", seed=1, **EMB_KW)
    elif route == "file":
        _lazy()[1].save(tmp_path / "emb.pt")
        model = EmbeddingModel.from_pretrained(str(tmp_path / "emb.pt"), device="cpu")
    elif route == "torch":
        torch.manual_seed(0)
        torch.save(TorchXVectorSincNet(dimension=16).state_dict(), tmp_path / "x.pt")
        model = EmbeddingModel.from_pretrained(str(tmp_path / "x.pt"), device="cpu")
    else:
        model = EmbeddingModel.from_apply(lambda w: w.transpose(1, 2), lambda f, w: f[:, None, :1, :].sum(2),
                                          embedding_dim=1, device="cpu")
    assert not model.is_in_memory()
    assert model.embedding_dim in (1, 16) and model.is_in_memory()
    assert model.eval() is model and model.to("cpu") is model


def test_lazy_outputs_equal_eager():
    """A lazy registry model's outputs are bitwise those of a model wrapped
    around the same weights, built beforehand."""
    seg, emb = _lazy()
    eager_seg = SegmentationModel(SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=0,
                                                                  **SEG_KW).module, "eager", "cpu")
    eager_emb = EmbeddingModel(EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1,
                                                            **EMB_KW).module, "eager", "cpu")
    assert eager_seg.is_in_memory() and eager_emb.is_in_memory()
    wave = _wave()
    weights = torch.rand(2, seg.num_frames(16000), generator=torch.Generator().manual_seed(2))
    seg, emb = _lazy()
    assert torch.equal(seg(wave), eager_seg(wave))
    assert torch.equal(emb(wave, weights), eager_emb(wave, weights))
    assert torch.equal(emb.head(emb.trunk(wave)), eager_emb.head(eager_emb.trunk(wave)))


def test_with_dtype_before_and_after_load():
    """As diart_tpu's: before the load it applies at the load, after it the
    module is rebuilt; the parameters stay f32 and the outputs equal a
    model made in that dtype."""
    wave = _wave()
    bf16 = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, dtype="bf16", **EMB_KW)
    f32 = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, **EMB_KW)
    before = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, **EMB_KW).with_dtype("bf16")
    assert not before.is_in_memory()
    assert before.module.compute_dtype == torch.bfloat16
    assert torch.equal(before(wave), bf16(wave))
    after = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=1, dtype="bf16", **EMB_KW).load()
    assert after.with_dtype("f32") is after and after.module.compute_dtype == torch.float32
    assert torch.equal(after(wave), f32(wave))
    assert all(p.dtype == torch.float32 for p in after.module.parameters())
    same = after.module
    assert after.with_dtype("f32").module is same  # no rebuild when nothing changes
    jax_model = JaxEmbeddingModel.from_registry("tpu/xvector", **EMB_KW).with_dtype("bf16")
    assert not jax_model.is_in_memory()
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=0, **SEG_KW).with_dtype("bf16")
    assert seg.module.compute_dtype == torch.bfloat16


def test_to_places_the_model():
    """``to`` loads the model on the device asked for; a model that is not
    built yet is built there directly; a callable holding its own weights
    cannot move; no GPU raises as the constructors do."""
    seg, _ = _lazy()
    assert seg.to("meta") is seg and seg.device == torch.device("meta")
    assert all(p.device.type == "meta" for p in seg.module.parameters())
    loaded, _ = _lazy()
    loaded.load()
    assert loaded.to(torch.device("meta")).device == torch.device("meta")
    assert all(p.device.type == "meta" for p in loaded.module.parameters())
    for load_first in (True, False):
        fn = SegmentationModel.from_apply(lambda w: w[:, :, ::160].transpose(1, 2), device="cpu")
        if load_first:
            fn.load()
        with pytest.raises(TypeError, match="cannot be moved"):
            fn.to("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            _lazy()[0].to("cuda")


def test_pickle_carries_the_loader_and_no_tensor():
    """An unloaded model pickles with no tensor; so does a loaded registry
    model (its loader, not its weights); the copy is not in memory and
    builds the same weights."""
    seg, emb = _lazy()
    assert _tensors_in_pickle(seg) == 0 and _tensors_in_pickle(emb) == 0
    wave = _wave()
    want = emb(wave)
    assert _tensors_in_pickle(emb) == 0 and _tensors_in_pickle(seg.load()) == 0
    copy = pickle.loads(pickle.dumps(emb))
    assert not copy.is_in_memory() and torch.equal(copy(wave), want)
    staged = EmbeddingModel.from_pretrained("tpu/xvector", device="cpu", seed=1, **EMB_KW)
    assert len(pickle.dumps(staged)) < 4096
    held = SegmentationModel(seg.module, "held", "cpu")
    assert _tensors_in_pickle(held) > 0  # a module passed in crosses as it is


def test_powerset_and_file_meta(tmp_path):
    """A powerset registry model knows its declaration before the load; a
    model file's powerset comes with its load."""
    ps = SegmentationModel.from_registry("tpu/pyannet-powerset", device="cpu", seed=0, **SEG_KW)
    assert ps.powerset == (3, 2) and not ps.is_in_memory()
    ps.save(tmp_path / "ps.pt")
    back = SegmentationModel.from_pretrained(str(tmp_path / "ps.pt"), device="cpu")
    assert back.powerset == (3, 2) and back.is_in_memory()
    wave = _wave()
    assert torch.equal(back(wave), ps(wave))


class _FakeSegmentation:
    """tests/test_torch_pipeline.py's fake segmentation as a module-level
    callable, so that spawn workers can unpickle it."""

    def __call__(self, wave):
        return torch.clamp(_band_amplitudes(wave)[..., :len(SPEAKER_FREQS)] / TONE_AMPLITUDE, 0.0, 1.0)


class _FakeHead:
    """tests/test_torch_pipeline.py's fake embedding head, module-level."""

    def __call__(self, frames, weights):
        num_frames, src = frames.shape[1], weights.shape[-1]
        idx = torch.arange(num_frames) * src // (src if src == num_frames else num_frames)
        w = weights.index_select(-1, idx)
        total = torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
        return torch.einsum("btc,bst->bsc", frames, w / total)


@pytest.mark.parametrize("latency", golden_config.GOLDEN_LATENCIES)
def test_parallelize_with_lazy_models_reproduces_golden(latency):
    """``Parallelize`` (2 spawn workers) over two copies of a golden
    fixture's audio, with lazy ``from_apply`` fakes: each file's text holds
    the committed fixture under test_golden.py's rule (bit-exact, else DER
    drift < 0.005), and equals the sequential Benchmark's."""
    seg = SegmentationModel.from_apply(_FakeSegmentation(), sample_rate=SAMPLE_RATE,
                                       num_speakers=len(SPEAKER_FREQS), device="cpu")
    emb = EmbeddingModel.from_apply(_band_amplitudes, _FakeHead(), sample_rate=SAMPLE_RATE,
                                    embedding_dim=len(SPEAKER_FREQS), device="cpu")
    assert not seg.is_in_memory() and not emb.is_in_memory()
    config = SpeakerDiarizationConfig(segmentation=seg, embedding=emb, duration=2.0, step=0.5,
                                      latency=latency, max_speakers=8, sample_rate=SAMPLE_RATE,
                                      tau_active=0.6, rho_update=0.1, delta_new=0.7)
    golden = (GOLDEN_DIR / f"synth_latency{latency}.rttm").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        audio = Path(tmp) / "audio"
        audio.mkdir()
        pcm = synth_audio(golden_config.GOLDEN_TURNS, golden_config.TOTAL, seed=123)
        for uri in ("synth", "synth_copy"):
            write_wav(audio / f"{uri}.wav", pcm, SAMPLE_RATE)
        par = Parallelize(Benchmark(audio, None, Path(tmp) / "par", show_progress=False), num_workers=2)
        texts = [p.to_rttm() for p in par(SpeakerDiarization, config)]
        seq = Benchmark(audio, None, Path(tmp) / "seq", show_progress=False)(SpeakerDiarization, config)
    assert texts == [p.to_rttm() for p in seq]
    assert texts[1] == texts[0].replace("SPEAKER synth ", "SPEAKER synth_copy ")
    if texts[0] == golden:
        print(f"synth_latency{latency}.rttm: bit-exact")
        return
    from test_torch_runtime import _parse_rttm

    drift = DiarizationErrorRate()(_parse_rttm(golden), _parse_rttm(texts[0]))
    print(f"synth_latency{latency}.rttm: DER drift {drift:.6f} (limit 0.005)")
    assert drift < 0.005


# ---------------------------------------------------------------------- #
# the per-family checkpoint loaders
# ---------------------------------------------------------------------- #
LOADERS = {
    "load_xvector_checkpoint": (lambda: TorchXVectorSincNet(dimension=64), "XVectorSincNet"),
    "load_ecapa_checkpoint": (lambda: SBEcapaTDNN(lin_neurons=32, channels=(32, 32, 32, 32, 96)), "EcapaTDNN"),
    "load_resnet_checkpoint": (lambda: WSResNet34(embed_dim=32, m_channels=8), "ResNet34"),
    "load_titanet_checkpoint": (lambda: NMTitaNet(channels=32, embed_dim=32), "TitaNet"),
    "load_xvect_sb_checkpoint": (
        lambda: SBXVector(in_channels=24, lin_neurons=32, tdnn_channels=(16, 16, 16, 16, 48)), "XVectorFbank"),
}


def _randomize_norms(net, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in net.modules():
            if isinstance(sub, torch.nn.modules.batchnorm._BatchNorm):
                n = sub.num_features
                sub.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                sub.bias.copy_(0.1 * torch.randn(n, generator=gen))
                sub.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                sub.running_var.copy_(1.0 + 0.2 * torch.rand(n, generator=gen))
    return net.eval()


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=f"{path}/{key}")


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_family_loader_equals_jax(tmp_path, loader):
    """The port's loader on a seeded replica's checkpoint: the module
    diart_tpu's loader builds (same class), its parameters exactly
    diart_tpu's, the same as ``load_embedding_checkpoint``'s; exported in
    ``__all__``."""
    make, cls = LOADERS[loader]
    torch.manual_seed(sorted(LOADERS).index(loader))
    net = _randomize_norms(make(), 7)
    path = tmp_path / "ckpt.pt"
    torch.save(net.state_dict(), path)
    module, meta = getattr(convert, loader)(path)
    jmodule, jparams, jmeta = getattr(jax_convert, loader)(path)
    assert type(module).__name__ == type(jmodule).__name__ == cls
    assert meta["source"] == jmeta["source"] == str(path) and meta["sample_rate"] == jmeta["sample_rate"]
    _assert_trees_equal(flax_params(module), jparams)
    sniffed, _ = convert.load_embedding_checkpoint(path)
    assert type(sniffed) is type(module)
    assert all(torch.equal(a, b) for a, b in zip(sniffed.state_dict().values(), module.state_dict().values()))
    assert loader in convert.__all__
    if loader == "load_xvector_checkpoint":
        from_sd, _ = convert.load_xvector_checkpoint_from_sd(net.state_dict(), "sd")
        _, jparams_sd, _ = jax_convert.load_xvector_checkpoint_from_sd(net.state_dict(), "sd")
        _assert_trees_equal(flax_params(from_sd), jparams_sd)


def test_models_package_exports():
    """diart_tpu.models' names, and the port's LazyModel, from the port's
    package."""
    for name in ("LazyModel", "BiLSTM", "SincConv", "SincNet", "num_sincnet_frames", "resample_weights",
                 "weighted_stats_pool", "log_mel_filterbank", "mel_filter_matrix", "num_fbank_frames"):
        assert name in models.__all__ and hasattr(models, name), name
