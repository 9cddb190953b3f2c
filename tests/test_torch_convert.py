"""Checkpoint conversion and model files of the port (diart_tpu_torch).

Each converter of ``diart_tpu_torch.models.convert`` on a seeded state dict
of its torch replica (``tests/torch_replicas.py``, batch norms given random
statistics so their mapping is exercised): the numpy tree equals the JAX
converter's exactly, and the port's model built from the checkpoint
matches the replica's own torch forward, and ``diart_tpu``'s model built
from the same file. Then the powerset declaration and its class-count
check, the prefixed wespeaker checkpoint, the unsafe-pickle opt-in, the
native ``save`` -> ``from_pretrained`` round trip of every family, the
refusal of flax ``.msgpack`` files and the convert CLI. Everything runs on
the CPU in f32.
"""

import json
import sys

import numpy as np
import pytest
import torch

from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.models import convert as jax_convert
from diart_tpu_torch.models import EmbeddingModel, SegmentationModel, convert
from diart_tpu_torch.models.powerset import powerset_mapping

from torch_replicas import (
    NMTitaNet,
    SBEcapaTDNN,
    SBXVector,
    TorchPyanNet,
    TorchXVectorSincNet,
    WSResNet34,
    kaldi_fbank,
    nemo_fbank,
    sb_fbank,
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randomize_norms(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random affine and running statistics for every batch norm."""
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


# the five embedding families' replicas at the widths of
# tests/test_engine_families.py, and the JAX converter of each
REPLICAS = {
    "xvector": (lambda: TorchXVectorSincNet(dimension=64), "xvector_params_from_state_dict"),
    "ecapa": (lambda: SBEcapaTDNN(lin_neurons=32, channels=(32, 32, 32, 32, 96)),
              "ecapa_params_from_state_dict"),
    "resnet34": (lambda: WSResNet34(embed_dim=32, m_channels=8), "resnet_params_from_state_dict"),
    "titanet": (lambda: NMTitaNet(channels=32, embed_dim=32), "titanet_params_from_state_dict"),
    "xvect-sb": (lambda: SBXVector(in_channels=24, lin_neurons=32, tdnn_channels=(16, 16, 16, 16, 48)),
                 "xvect_sb_params_from_state_dict"),
}
MODULES = {"xvector": "XVectorSincNet", "ecapa": "EcapaTDNN", "resnet34": "ResNet34",
           "titanet": "TitaNet", "xvect-sb": "XVectorFbank"}


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=f"{path}/{key}")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each replica, seeded, saved as a plain state dict."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for i, (name, (make, _)) in enumerate(sorted(REPLICAS.items())):
        torch.manual_seed(100 + i)
        net = _randomize_norms(make(), 200 + i)
        path = root / f"{name}.pt"
        torch.save(net.state_dict(), path)
        out[name] = (net, path)
    return out


@pytest.mark.parametrize("family", sorted(REPLICAS))
def test_converter_tree_equals_jax(checkpoints, family):
    net, _ = checkpoints[family]
    fn = REPLICAS[family][1]
    sd = net.state_dict()
    _assert_trees_equal(getattr(convert, fn)(sd), getattr(jax_convert, fn)(sd))


def test_pyannet_converter_tree_equals_jax():
    torch.manual_seed(3)
    sd = TorchPyanNet(num_speakers=7, lstm_hidden=16, lstm_layers=2, linear_dims=(16, 16)).state_dict()
    _assert_trees_equal(convert.pyannet_params_from_state_dict(sd, 2),
                        jax_convert.pyannet_params_from_state_dict(sd, 2))


# converted model vs the replica's torch forward: f32 on both sides, sums in
# another order; the tolerance relative to max(1, |embedding|), as
# tests/test_convert.py holds the JAX package (2e-4; 5e-4 for TitaNet from
# the waveform, whose frontend error passes through the per-feature norm)
FEATS = {"ecapa": (120, 80), "resnet34": (96, 80), "titanet": (90, 80), "xvect-sb": (120, 24)}


@pytest.mark.parametrize("family", sorted(FEATS))
def test_converted_model_matches_replica_features(checkpoints, family):
    net, path = checkpoints[family]
    emb = EmbeddingModel.from_pretrained(str(path), device="cpu")
    assert type(emb.module).__name__ == MODULES[family]
    assert emb.embedding_dim == 32
    t, mels = FEATS[family]
    feats = np.random.default_rng(9).normal(size=(2, t, mels)).astype(np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(feats)).numpy()
        frames = emb.module.trunk_from_features(torch.from_numpy(feats))
        got = emb.head(frames).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale)


WAVE_FRONTENDS = {
    "resnet34": (lambda w: kaldi_fbank(w), True, 2e-4),
    "xvect-sb": (lambda w: sb_fbank(w, n_mels=24), True, 2e-4),
    "titanet": (lambda w: nemo_fbank(w), False, 5e-4),
    "ecapa": (lambda w: sb_fbank(w), True, 2e-4),
}


@pytest.mark.parametrize("family", sorted(WAVE_FRONTENDS))
def test_converted_model_matches_replica_waveform(checkpoints, family):
    """From raw 16 kHz audio: the port's frontend + converted network
    against the replica's frontend (+ CMN where the recipe has it) and
    network."""
    net, path = checkpoints[family]
    frontend, cmn, tol = WAVE_FRONTENDS[family]
    emb = EmbeddingModel.from_pretrained(str(path), device="cpu")
    wave = np.random.default_rng(10).normal(scale=0.1, size=(2, 1, 32000)).astype(np.float32)
    with torch.no_grad():
        feats = frontend(torch.from_numpy(wave[:, 0]))
        if cmn:
            feats = feats - feats.mean(dim=1, keepdim=True)
        ref = net(feats).numpy()
        got = emb(torch.from_numpy(wave)).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, atol=tol * scale)


@pytest.mark.parametrize("family", sorted(REPLICAS))
def test_converted_model_matches_jax(checkpoints, family):
    """The same checkpoint file through both packages' from_pretrained:
    embeddings of the same waveform and weights within 1e-4 x max(1, |emb|)."""
    _, path = checkpoints[family]
    jemb = JaxEmbeddingModel.from_pretrained(str(path))
    pemb = EmbeddingModel.from_pretrained(str(path), device="cpu")
    rng = np.random.default_rng(11)
    wave = rng.normal(scale=0.1, size=(2, 1, 16000)).astype(np.float32)
    weights = rng.uniform(size=(2, 59)).astype(np.float32)
    want = np.asarray(jemb(wave, weights))
    got = pemb(torch.from_numpy(wave), torch.from_numpy(weights)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_pyannet_checkpoint_matches_replica_and_jax(tmp_path):
    torch.manual_seed(11)
    net = TorchPyanNet(num_speakers=4, lstm_hidden=16, lstm_layers=2, linear_dims=(16, 16)).eval()
    path = tmp_path / "pyannet.pt"
    torch.save(net.state_dict(), path)
    seg = SegmentationModel.from_pretrained(str(path), device="cpu")
    assert seg.module.lstm_layers == 2 and seg.module.linear_dims == (16, 16) and seg.powerset is None
    wave = np.random.default_rng(3).normal(scale=0.2, size=(2, 1, 32000)).astype(np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(wave)).numpy()
    got = seg(torch.from_numpy(wave)).numpy()
    want = np.asarray(JaxSegmentationModel.from_pretrained(str(path))(wave))
    assert got.shape == ref.shape == want.shape == (2, 115, 4)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _powerset_checkpoint(path):
    torch.manual_seed(41)
    net = TorchPyanNet(num_speakers=7, lstm_hidden=16, lstm_layers=1, linear_dims=(16,)).eval()
    torch.save(net.state_dict(), path)
    return net


def test_powerset_declaration(tmp_path):
    """A raw 7-output checkpoint declared powerset (3, 2) decodes to 3
    speakers: the argmax class of the torch logits through the mapping,
    and the JAX package's decode of the same file. The smallest top-1 -
    top-2 logit margin is printed: equality at the argmax holds where it
    exceeds the f32 error of the two forwards (~1e-5)."""
    path = tmp_path / "ps.pt"
    net = _powerset_checkpoint(path)
    seg = SegmentationModel.from_pretrained(str(path), device="cpu", powerset=(3, 2))
    assert seg.powerset == (3, 2) and seg.num_speakers == 3 and seg.module.powerset_classes == 7
    wave = np.random.default_rng(1).normal(scale=0.2, size=(1, 1, 32000)).astype(np.float32)
    out = seg(torch.from_numpy(wave)).numpy()
    with torch.no_grad():
        x = net.sincnet(torch.from_numpy(wave)).transpose(1, 2)
        x, _ = net.lstm(x)
        for lin in net.linear:
            x = torch.nn.functional.leaky_relu(lin(x))
        logits = net.classifier(x).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    print(f"min top-1 - top-2 logit margin: {float((top2[..., 1] - top2[..., 0]).min()):.3e}")
    np.testing.assert_array_equal(out, powerset_mapping(3, 2)[logits.argmax(-1)])
    want = np.asarray(JaxSegmentationModel.from_pretrained(str(path), powerset=(3, 2))(wave))
    np.testing.assert_array_equal(out, want)


def test_powerset_class_mismatch_raises(tmp_path):
    torch.manual_seed(42)
    path = tmp_path / "bad_ps.pt"
    torch.save(TorchPyanNet(num_speakers=4, lstm_hidden=16, lstm_layers=1).state_dict(), path)
    with pytest.raises(ValueError, match="implies 7 classes"):
        SegmentationModel.from_pretrained(str(path), device="cpu", powerset=(3, 2))


def test_prefixed_resnet_checkpoint(tmp_path, checkpoints):
    """pyannote-wrapped wespeaker checkpoints prefix their keys with
    'resnet.'; the sniffing loader strips it."""
    net, plain = checkpoints["resnet34"]
    path = tmp_path / "wrapped.pt"
    torch.save({f"resnet.{k}": v for k, v in net.state_dict().items()}, path)
    wrapped = EmbeddingModel.from_pretrained(str(path), device="cpu")
    assert type(wrapped.module).__name__ == "ResNet34" and wrapped.embedding_dim == 32
    for key, value in EmbeddingModel.from_pretrained(str(plain), device="cpu").module.state_dict().items():
        assert torch.equal(wrapped.module.state_dict()[key], value), key


class _SneakyPayload:
    """Module-level so torch.save can pickle it; weights_only=True must
    still refuse to load it."""


def test_unsafe_pickle_needs_opt_in(tmp_path, monkeypatch):
    """A checkpoint that needs full unpickling is refused unless trusted
    (``trust_pickle=True`` or DIART_TPU_TRUST_CHECKPOINTS=1); a plain
    tensor checkpoint loads on the safe path, its wrapper keys unwrapped."""
    ok = tmp_path / "ok.pt"
    torch.save({"state_dict": {"model.w": torch.ones(3)}}, ok)
    assert list(convert._load_torch_state_dict(ok)) == ["w"]
    path = tmp_path / "sneaky.pt"
    torch.save({"state_dict": {"w": torch.ones(2)}, "obj": _SneakyPayload()}, path)
    monkeypatch.delenv("DIART_TPU_TRUST_CHECKPOINTS", raising=False)
    with pytest.raises(RuntimeError, match="DIART_TPU_TRUST_CHECKPOINTS"):
        convert._load_torch_state_dict(path)
    assert "w" in convert._load_torch_state_dict(path, trust_pickle=True)
    monkeypatch.setenv("DIART_TPU_TRUST_CHECKPOINTS", "1")
    assert "w" in convert._load_torch_state_dict(path)


# --------------------------------------------------------------------- #
# native files


def _state_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("family", sorted(REPLICAS))
def test_native_round_trip(tmp_path, checkpoints, family):
    """save -> from_pretrained gives the same class, config and state, and
    the JAX package's config schema; a bf16 compute dtype survives."""
    _, path = checkpoints[family]
    emb = EmbeddingModel.from_pretrained(str(path), device="cpu", dtype="bf16")
    assert emb.module.compute_dtype == torch.bfloat16
    out = tmp_path / "native.pt"
    emb.save(out)
    config = json.loads((tmp_path / "native.pt.json").read_text())
    assert config["module_class"] == MODULES[family] and config["module"]["compute_dtype"] == "bf16"
    back = EmbeddingModel.from_pretrained(str(out), device="cpu")
    assert type(back.module) is type(emb.module) and back.module.compute_dtype == torch.bfloat16
    assert _state_equal(back.module, emb.module)
    wave = torch.from_numpy(np.random.default_rng(4).normal(scale=0.1, size=(1, 1, 16000)).astype(np.float32))
    assert torch.equal(back(wave), emb(wave))


@pytest.mark.parametrize("name,kwargs", [
    ("tpu/pyannet", dict(lstm_hidden=16, lstm_layers=1, linear_dims=(16,))),
    ("tpu/pyannet-powerset", dict(lstm_hidden=16, lstm_layers=1, linear_dims=(16,))),
])
def test_native_round_trip_segmentation(tmp_path, name, kwargs):
    seg = SegmentationModel.from_registry(name, device="cpu", seed=0, **kwargs)
    out = tmp_path / "seg.pt"
    seg.save(out)
    config = json.loads((tmp_path / "seg.pt.json").read_text())
    assert config["module_class"] == "PyanNet"
    assert config.get("powerset") == ([3, 2] if name.endswith("powerset") else None)
    back = SegmentationModel.from_pretrained(str(out), device="cpu")
    assert back.powerset == seg.powerset and back.num_speakers == seg.num_speakers
    assert _state_equal(back.module, seg.module)
    wave = torch.from_numpy(np.random.default_rng(5).normal(scale=0.1, size=(1, 1, 16000)).astype(np.float32))
    assert torch.equal(back(wave), seg(wave))


def test_flax_files_are_refused(tmp_path):
    """The flax .msgpack and .npz files diart_tpu writes load (they were
    refused before the port read flax msgpack): a segmentation and an
    embedding file, each equal to the JAX model on a seeded input within
    1e-5 (f32, sums in another order). A torn one is refused, its error
    naming both formats."""
    seg_kw = dict(lstm_hidden=16, lstm_layers=1, linear_dims=(16,))
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **seg_kw)
    jemb = JaxEmbeddingModel.from_registry(
        "tpu/xvect-sb", init_samples=8000, embedding_dim=32,
        tdnn_specs=((5, 1, 16), (3, 2, 16), (3, 3, 16), (1, 1, 16), (1, 1, 48)))
    jseg.save(tmp_path / "seg.msgpack")
    jemb.save(tmp_path / "emb.npz")
    wave = np.random.default_rng(5).normal(scale=0.1, size=(2, 1, 8000)).astype(np.float32)
    seg = SegmentationModel.from_pretrained(str(tmp_path / "seg.msgpack"), device="cpu")
    emb = EmbeddingModel.from_pretrained(str(tmp_path / "emb.npz"), device="cpu")
    np.testing.assert_allclose(seg(torch.from_numpy(wave)).numpy(), np.asarray(jseg(wave)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb(torch.from_numpy(wave)).numpy(), np.asarray(jemb(wave)), rtol=1e-5, atol=1e-5)
    data = (tmp_path / "seg.msgpack").read_bytes()
    (tmp_path / "seg.msgpack").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="torch.save zip.*flax msgpack"):
        SegmentationModel.from_pretrained(str(tmp_path / "seg.msgpack"), device="cpu")


def test_save_refuses_callables():
    seg = SegmentationModel.from_apply(lambda w: w[:, :, ::160].transpose(1, 2), device="cpu")
    with pytest.raises(TypeError, match="cannot be serialized"):
        seg.save("unused.pt")


def test_pyannote_names_need_pyannote_audio():
    for cls in (SegmentationModel, EmbeddingModel):
        with pytest.raises(ImportError, match="pyannote.audio"):
            cls.from_pretrained("pyannote/segmentation-3.0", device="cpu")


def test_convert_cli(tmp_path, checkpoints, monkeypatch, capsys):
    """The convert CLI (in process, --cpu --check): an embedding checkpoint
    and a powerset segmentation checkpoint to native files equal to the
    in-process conversion."""
    from diart_tpu_torch.console import convert as cli

    _, emb_path = checkpoints["titanet"]
    seg_path = tmp_path / "ps.pt"
    _powerset_checkpoint(seg_path)
    for kind, src, extra in (("embedding", emb_path, []), ("segmentation", seg_path, ["--powerset", "3", "2"])):
        out = tmp_path / f"{kind}.pt"
        monkeypatch.setattr(sys, "argv", ["convert", kind, str(src), str(out), "--cpu", "--check", *extra])
        cli.run()
        printed = capsys.readouterr().out
        assert "check ok" in printed, printed
        cls = SegmentationModel if kind == "segmentation" else EmbeddingModel
        want = cls.from_pretrained(str(src), device="cpu", **({"powerset": (3, 2)} if extra else {}))
        got = cls.from_pretrained(str(out), device="cpu")
        assert _state_equal(got.module, want.module)
        assert getattr(got, "powerset", None) == getattr(want, "powerset", None)


def test_model_layer_imports_without_jax():
    """The converters, the ONNX stub, the convert CLI, the new families and
    the flax msgpack reader (with the readers of diart_tpu's files: the
    model files, the trainers' checkpoints, the session) import with jax,
    flax, msgpack and diart_tpu blocked (the port keeps its own copies of
    the JAX package's numpy mapping helpers and its own msgpack codec)."""
    import subprocess
    from pathlib import Path

    code = (
        "import sys\n"
        "for m in ('jax', 'diart_tpu', 'flax', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import diart_tpu_torch.models.convert, diart_tpu_torch.models.onnx\n"
        "import diart_tpu_torch.console.convert\n"
        "from diart_tpu_torch.models import ResNet34, TitaNet, XVectorFbank, to_multilabel\n"
        "import diart_tpu_torch.flaxio, diart_tpu_torch.train, diart_tpu_torch.parallel.session\n"
        "from diart_tpu_torch import flaxio\n"
        "assert flaxio.loads(flaxio.dumps({'a': {'b': 1}})) == {'a': {'b': 1}}\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'diart_tpu.', 'flax', 'msgpack'))\n"
        "            and sys.modules[m] is not None]\n"
    )
    repo = Path(__file__).parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=repo, env=dict(__import__("os").environ, PYTHONPATH=str(repo)))
    assert out.returncode == 0, out.stderr
