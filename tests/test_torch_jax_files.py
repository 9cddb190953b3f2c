"""The port reads what diart_tpu writes: flax msgpack (``diart_tpu_torch.flaxio``),
model files, training checkpoints and session checkpoints; and the stacked
SincNet frontend (``stack_frontend``), on the CPU.

Files are written by diart_tpu in the test (JAX on the CPU) or come from
``tests/golden/jax_files/`` (``tests/make_jax_files.py``), whose stored
outputs the port is held against. Inputs come from numpy seeds; the port
runs its kernels' plain versions (CPU tensors), JAX its portable paths.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from diart_tpu import precision as jax_precision
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu.parallel import MultiStreamSession as JaxMultiStreamSession
from diart_tpu.train import embedding_train_step as jax_embedding_train_step
from diart_tpu.train import make_embedding_train_state as jax_make_embedding_train_state
from diart_tpu.train import make_train_state as jax_make_train_state
from diart_tpu.train import save_train_state as jax_save_train_state
from diart_tpu.train import train_step as jax_train_step
from diart_tpu.train.segmentation import TrainState as JaxTrainState
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, MultiStreamSession, SegmentationModel, flaxio
from diart_tpu_torch.parallel import streams_mesh
from diart_tpu_torch.precision import Precision
from diart_tpu_torch.train import (
    embedding_train_step,
    latest_checkpoint,
    make_embedding_train_state,
    make_train_state,
    restore_train_state,
    save_train_state,
    train_step,
)
from diart_tpu_torch.weights import flatten_flax, flax_params

from test_torch_families import FAMILIES, jax_registry

FILES = Path(__file__).parent / "golden" / "jax_files"
SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
PS_KW = dict(num_speakers=3, max_simultaneous=2, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
XVEC_KW = dict(embedding_dim=16)
ECAPA_KW = dict(embedding_dim=16, channels=32)
ENGINE_KW = dict(duration=2.0, step=0.5, latency=0.5, sample_rate=16000, max_speakers=4,
                 tau_active=0.45, rho_update=0.05)
LR = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def stored():
    with np.load(FILES / "outputs.npz") as data:
        return {k: data[k] for k in data.files}


def _same_tree(got, want, path=""):
    """``flaxio.loads``' tree against ``msgpack_restore``'s: the same keys,
    types, dtypes, shapes and values (bfloat16 as its bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        assert np.array_equal(got.view(torch.uint16).numpy(), np.asarray(want).view(np.uint16)), path
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        if isinstance(want, (np.ndarray, np.generic)):
            assert got.dtype == want.dtype and np.shape(got) == np.shape(want), path
            assert np.array_equal(got, want, equal_nan=True), path
        else:
            assert got == want or (got != got and want != want), path


# --------------------------------------------------------------------- #
# flaxio against flax
# --------------------------------------------------------------------- #
FIXTURE_FILES = ["models/pyannet.msgpack", "models/xvector.npz", "models/ecapa.msgpack",
                 "session.msgpack", "train/step_00000002.msgpack", "train_after.msgpack"]


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_loads_matches_flax_on_diart_tpu_files(name):
    """Files diart_tpu wrote: ``loads`` gives flax's tree, and ``dumps``
    of it gives the file's bytes back."""
    data = (FILES / name).read_bytes()
    tree = flaxio.loads(data)
    _same_tree(tree, serialization.msgpack_restore(data))
    assert flaxio.dumps(tree) == data


_DTYPES = [np.float32, np.int32, np.bool_, np.float64, np.int8, np.uint16, "bfloat16"]


def _array(draw, shape):
    dtype = draw(st.sampled_from(_DTYPES))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    values = rng.normal(size=shape) * 100
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(values, jnp.bfloat16))
    if dtype == np.bool_:
        return values > 0
    return values.astype(dtype)


@st.composite
def _leaves(draw):
    kind = draw(st.sampled_from(["array", "scalar", "int", "float", "str", "none", "bool", "complex"]))
    if kind == "array":
        return _array(draw, tuple(draw(st.lists(st.integers(0, 5), max_size=3))))
    if kind == "scalar":
        return _array(draw, ())[()]
    if kind == "int":
        return draw(st.integers(-(2**63), 2**64 - 1))
    if kind == "float":
        return draw(st.floats(allow_nan=False))
    if kind == "str":
        return draw(st.text(max_size=300))
    if kind == "complex":
        return complex(draw(st.floats(-1e6, 1e6)), draw(st.floats(-1e6, 1e6)))
    return None if kind == "none" else draw(st.booleans())


_trees = st.recursive(
    _leaves(), lambda children: st.dictionaries(st.text(max_size=40), children, max_size=20), max_leaves=40)


@settings(max_examples=60, deadline=None)
@given(tree=st.dictionaries(st.text(max_size=20), _trees, max_size=6))
def test_flaxio_matches_flax_on_drawn_trees(tree):
    """Drawn trees (f32, bf16, int, bool arrays of any shape, numpy scalars,
    ints of every msgpack width, floats, str, complex, None, empty and
    nested maps): ``dumps`` is byte for byte ``msgpack_serialize``, and
    ``loads`` gives ``msgpack_restore``'s tree."""
    data = serialization.msgpack_serialize(tree)
    as_port = jax.tree_util.tree_map(  # the port holds bf16 arrays as tensors
        lambda x: torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
        if isinstance(x, np.ndarray) and x.dtype == jnp.bfloat16 else x, tree)
    assert flaxio.dumps(as_port) == data
    _same_tree(flaxio.loads(data), serialization.msgpack_restore(data))


def test_truncated_and_foreign_bytes_raise():
    """Every cut of a file raises ValueError (nothing half-read is
    returned); so do trailing bytes, a chunked array and a type byte
    msgpack does not use here."""
    data = (FILES / "models" / "titanet.msgpack").read_bytes()
    for cut in sorted({0, 1, 2, 10, 100, len(data) // 2, len(data) - 100, len(data) - 1}):
        with pytest.raises(ValueError):
            flaxio.loads(data[:cut])
    with pytest.raises(ValueError, match="trailing"):
        flaxio.loads(data + b"\x00")
    with pytest.raises(ValueError, match="chunked"):
        flaxio.loads(flaxio.dumps({"w": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}}))
    with pytest.raises(ValueError, match="0xc1"):
        flaxio.loads(b"\xc1")


# --------------------------------------------------------------------- #
# model files
# --------------------------------------------------------------------- #
MODEL_FILES = {  # fixture file -> the port's class
    "pyannet.msgpack": SegmentationModel, "xvector.npz": EmbeddingModel, "ecapa.msgpack": EmbeddingModel,
    "resnet34.msgpack": EmbeddingModel, "titanet.msgpack": EmbeddingModel, "xvect_sb.msgpack": EmbeddingModel,
}


def _port_out(model, wave, weights=None):
    with torch.no_grad():
        if isinstance(model, SegmentationModel):
            return model(torch.from_numpy(wave)).numpy()
        return model.head(model.trunk(torch.from_numpy(wave)), torch.from_numpy(weights)).numpy()


# 1e-5: f32 on both sides, sums in another order (ResNet34's 33
# convolutions give the largest gap, ~5e-6).
@pytest.mark.parametrize("name", sorted(MODEL_FILES))
def test_committed_model_files_match_stored_outputs(name, stored):
    """The six classes' files diart_tpu wrote, through ``from_pretrained``,
    against diart_tpu's outputs stored beside them."""
    model = MODEL_FILES[name].from_pretrained(str(FILES / "models" / name), device="cpu")
    config = json.loads((FILES / "models" / f"{name}.json").read_text())
    assert type(model.module).__name__ == config["module_class"]
    got = _port_out(model, stored["wave"], stored["weights"])
    np.testing.assert_allclose(got, stored[f"{name}:out"], rtol=1e-5, atol=1e-5)


JAX_MODELS = {
    "pyannet": (JaxSegmentationModel, "tpu/pyannet", SEG_KW),
    "pyannet-powerset": (JaxSegmentationModel, "tpu/pyannet-powerset", PS_KW),
    "xvector": (JaxEmbeddingModel, "tpu/xvector", XVEC_KW),
    "ecapa": (JaxEmbeddingModel, "tpu/ecapa", ECAPA_KW),
    **{name.split("/")[1]: (JaxEmbeddingModel, name, kw) for name, kw in FAMILIES.items()},
}


def _jax_out(jmodel, wave, weights):
    if isinstance(jmodel, JaxSegmentationModel):
        return np.asarray(jmodel(jnp.asarray(wave)))
    frames = jmodel.trunk_fn()(jmodel.params, jnp.asarray(wave))
    return np.asarray(jmodel.head_fn()(jmodel.params, frames, jnp.asarray(weights)))


def _save_and_load(jmodel, path):
    jmodel.save(path)
    cls = SegmentationModel if isinstance(jmodel, JaxSegmentationModel) else EmbeddingModel
    return cls.from_pretrained(str(path), device="cpu")


# 1e-5 as above.
@pytest.mark.parametrize("kind", sorted(JAX_MODELS))
def test_model_files_match_jax(kind, tmp_path):
    """diart_tpu's ``save`` of each registry model at narrow width, then
    the port's ``from_pretrained``: the module class and powerset from the
    config, outputs within 1e-5 of the JAX model's on a seeded input, and
    ``flaxio.dumps(flax_params(module))`` the file's bytes."""
    cls, name, kw = JAX_MODELS[kind]
    jmodel = jax_registry(cls, name, init_samples=8000, **kw)
    suffix = ".npz" if kind == "xvector" else ".msgpack"
    model = _save_and_load(jmodel, tmp_path / f"{kind}{suffix}")
    assert type(model.module).__name__ == type(jmodel.module).__name__
    if kind == "pyannet-powerset":
        assert model.powerset == (3, 2) and model.num_speakers == 3
    rng = np.random.default_rng(3)
    wave = rng.normal(scale=0.1, size=(2, 1, 8000)).astype(np.float32)
    weights = rng.uniform(size=(2, 3, 40)).astype(np.float32)
    np.testing.assert_allclose(_port_out(model, wave, weights), _jax_out(jmodel, wave, weights),
                               rtol=1e-5, atol=1e-5)
    assert flaxio.dumps(flax_params(model.module)) == (tmp_path / f"{kind}{suffix}").read_bytes()


# 1e-5 as above; the 4-layer BiLSTM and the 1500-wide statistics are the
# longest chains of sums.
@pytest.mark.parametrize("kind", ["pyannet", "xvector"])
def test_full_width_model_files_match_jax(kind, tmp_path):
    cls, name = {"pyannet": (JaxSegmentationModel, "tpu/pyannet"),
                 "xvector": (JaxEmbeddingModel, "tpu/xvector")}[kind]
    jmodel = jax_registry(cls, name, init_samples=16000)
    model = _save_and_load(jmodel, tmp_path / f"{kind}.msgpack")
    rng = np.random.default_rng(4)
    wave = rng.normal(scale=0.1, size=(2, 1, 16000)).astype(np.float32)
    weights = rng.uniform(size=(2, 4, 50)).astype(np.float32)
    np.testing.assert_allclose(_port_out(model, wave, weights), _jax_out(jmodel, wave, weights),
                               rtol=1e-5, atol=1e-5)


def test_model_file_formats_are_told_by_their_bytes(tmp_path):
    """A diart_tpu file under a torch suffix is read as flax; the port's
    native file under ``.msgpack`` as torch; a config without
    ``module_class`` takes the role's default class; a file of neither
    format raises naming both; a flax suffix without its config raises."""
    src = FILES / "models" / "pyannet.msgpack"
    config = json.loads(Path(f"{src}.json").read_text())
    want = SegmentationModel.from_pretrained(str(src), device="cpu")
    (tmp_path / "a.pt").write_bytes(src.read_bytes())
    Path(f"{tmp_path / 'a.pt'}.json").write_text(json.dumps(config))
    got = SegmentationModel.from_pretrained(str(tmp_path / "a.pt"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.module.state_dict().values(),
                                                 want.module.state_dict().values()))
    want.save(tmp_path / "native.pt")
    (tmp_path / "b.msgpack").write_bytes((tmp_path / "native.pt").read_bytes())
    Path(f"{tmp_path / 'b.msgpack'}.json").write_text(Path(f"{tmp_path / 'native.pt'}.json").read_text())
    back = SegmentationModel.from_pretrained(str(tmp_path / "b.msgpack"), device="cpu")
    assert back.module.state_dict().keys() == want.module.state_dict().keys()
    bare = {k: v for k, v in config.items() if k != "module_class"}
    (tmp_path / "c.msgpack").write_bytes(src.read_bytes())
    Path(f"{tmp_path / 'c.msgpack'}.json").write_text(json.dumps(bare))
    assert type(SegmentationModel.from_pretrained(str(tmp_path / "c.msgpack"), device="cpu").module).__name__ \
        == "PyanNet"
    (tmp_path / "d.npz").write_bytes(b"\x93NUMPY not a model")
    Path(f"{tmp_path / 'd.npz'}.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="torch.save zip.*flax msgpack"):
        EmbeddingModel.from_pretrained(str(tmp_path / "d.npz"), device="cpu")
    (tmp_path / "e.msgpack").write_bytes(src.read_bytes())
    with pytest.raises(FileNotFoundError, match="config"):
        SegmentationModel.from_pretrained(str(tmp_path / "e.msgpack"), device="cpu")


def test_mismatched_model_files_raise(tmp_path):
    """A tree that does not cover the configured module raises (strict
    mapping): the x-vector's file under PyanNet's config, and a file with
    one leaf removed."""
    src = FILES / "models" / "xvector.npz"
    seg_config = Path(FILES / "models" / "pyannet.msgpack.json").read_text()
    (tmp_path / "x.msgpack").write_bytes(src.read_bytes())
    Path(f"{tmp_path / 'x.msgpack'}.json").write_text(seg_config)
    with pytest.raises((KeyError, AttributeError, RuntimeError)):
        SegmentationModel.from_pretrained(str(tmp_path / "x.msgpack"), device="cpu")
    tree = flaxio.loads(src.read_bytes())
    del tree["params"]["embedding"]
    (tmp_path / "y.npz").write_bytes(flaxio.dumps(tree))
    Path(f"{tmp_path / 'y.npz'}.json").write_text(Path(f"{src}.json").read_text())
    with pytest.raises(RuntimeError, match="Missing key"):
        EmbeddingModel.from_pretrained(str(tmp_path / "y.npz"), device="cpu")


# --------------------------------------------------------------------- #
# session checkpoints
# --------------------------------------------------------------------- #
def _spy(engine, record, jax_side):
    step = engine.step

    def spy(state, blocks, audio_mask=None, run_mask=None):
        state, out = step(state, blocks, audio_mask, run_mask)
        agg = out.aggregated.cpu() if not jax_side else out.aggregated
        record.append(np.asarray(agg))
        return state, out

    engine.step = spy


def _texts(session, blocks):
    return [session.push_rttm(b) for b in blocks]


# the engines agree to atol 1e-4 (test_torch_engine.py); exact text needs
# every score it depends on farther than that from tau (printed)
@pytest.mark.parametrize("mesh", [None, 2], ids=["engine", "mesh2"])
def test_committed_session_resumes(mesh, stored):
    """diart_tpu's 2-stream x-vector session file restored onto the port's
    engine of the same two model files (its phase-major window laid out
    flat), unsharded and on a 2-slot CPU mesh: the next hops' aggregated
    scores within 1e-4 of diart_tpu's and the same RTTM text."""
    kw = json.loads(bytes(stored["session:engine"]).decode())
    seg = SegmentationModel.from_pretrained(str(FILES / "models" / "pyannet.msgpack"), device="cpu")
    emb = EmbeddingModel.from_pretrained(str(FILES / "models" / "xvector.npz"), device="cpu")
    engine = MultiStreamEngine(seg, emb, mesh=None if mesh is None else streams_mesh(devices=["cpu"] * mesh),
                               **kw)
    record = []
    _spy(engine, record, jax_side=False)
    session = MultiStreamSession(engine, tau_active=kw["tau_active"], collect_audio=False)
    session.restore(FILES / "session.msgpack")
    texts = _texts(session, stored["session:blocks"])
    want = stored["session:aggregated"]
    margin = np.abs(want - kw["tau_active"]).min()
    print(f"min |score - tau| of the stored hops: {margin:.3e}")
    assert margin > 1e-4
    np.testing.assert_allclose(np.stack(record), want, atol=1e-4)
    assert ["\x00".join(t or "" for t in hop).encode() for hop in texts] == list(stored["session:rttm"])


@pytest.fixture(scope="module")
def session_models():
    """(JAX, port) narrow PyanNet, x-vector and ECAPA on the same weights."""
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=8000, **SEG_KW)
    out = {"seg": (jseg, None)}
    for kind, name, kw in (("xvector", "tpu/xvector", XVEC_KW), ("ecapa", "tpu/ecapa", ECAPA_KW)):
        out[kind] = (jax_registry(JaxEmbeddingModel, name, init_samples=8000, **kw), None)
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    port = {
        "seg": SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW),
        "xvector": EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(out["xvector"][0]),
                                                **XVEC_KW),
        "ecapa": EmbeddingModel.from_registry("tpu/ecapa", device="cpu", flax_params=tree(out["ecapa"][0]),
                                              **ECAPA_KW),
    }
    return {k: (v[0], port[k]) for k, v in out.items()}


def _tone_blocks(seed, hops, batch):
    rng = np.random.default_rng(seed)
    t = np.arange(hops * 8000) / 16000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * (250.0 + 190.0 * b) * t) for b in range(batch)])
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 0.4 * t))[None] + 0.05 * rng.normal(size=sig.shape)
    return sig.astype(np.float32).reshape(batch, hops, 8000).transpose(1, 0, 2).copy()


@pytest.mark.parametrize("case", ["xvector", "ecapa", "xvector-mesh2", "ecapa-mesh2"])
def test_session_restore_matches_jax(case, session_models, tmp_path):
    """A JAX engine (the x-vector's phased window; ECAPA's with the mel frame
    ring, whose audio state is the dict {window, ring, head, tail}) runs 6
    hops, with one stream paused at hop 3, and saves (``.audio.npy``
    included); the port restores the file (unsharded and on a 2-slot CPU
    mesh) and both run 4 more hops: aggregated scores within 1e-4, the same
    RTTM text and the same collected audio."""
    kind, _, shards = case.partition("-mesh")
    (jseg, pseg), (jemb, pemb) = session_models["seg"], session_models[kind]
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, batch_size=2, **ENGINE_KW)
    audio = jeng.init_state().audio
    assert (isinstance(audio, dict) and audio["window"].ndim == 3) if kind == "ecapa" else audio.ndim == 3
    jrec, prec = [], []
    _spy(jeng, jrec, jax_side=True)
    jsession = JaxMultiStreamSession(jeng, tau_active=ENGINE_KW["tau_active"])
    blocks = _tone_blocks(5, 10, 2)
    present = np.array([True, False])
    for hop in range(6):
        jsession.push_rttm(blocks[hop], present if hop == 3 else None)
    jsession.save(tmp_path / "s.msgpack")
    seen = jsession.blocks_seen.tolist()
    jrec.clear()
    want = _texts(jsession, blocks[6:])
    mesh = streams_mesh(devices=["cpu"] * int(shards)) if shards else None
    peng = MultiStreamEngine(pseg, pemb, batch_size=2, mesh=mesh, **ENGINE_KW)
    _spy(peng, prec, jax_side=False)
    psession = MultiStreamSession(peng, tau_active=ENGINE_KW["tau_active"])
    psession.restore(tmp_path / "s.msgpack")
    assert psession.blocks_seen.tolist() == seen == [6, 5]
    got = _texts(psession, blocks[6:])
    margin = np.abs(np.stack(jrec) - ENGINE_KW["tau_active"]).min()
    print(f"min |score - tau| of the JAX hops ({case}): {margin:.3e}")
    assert margin > 1e-4
    np.testing.assert_allclose(np.stack(prec), np.stack(jrec), atol=1e-4)
    assert got == want and any(t for hop in got for t in hop)
    np.testing.assert_array_equal(psession._audio, jsession._audio)


def test_mismatched_sessions_raise(tmp_path):
    """A JAX session file restored onto an engine of other geometry (3
    streams), or a file that is not a session, raises and leaves the
    session's state as it was."""
    kw = json.loads(Path(FILES / "session.json").read_text())
    assert kw["uris"] == ["stream0", "stream1"]
    seg = SegmentationModel.from_pretrained(str(FILES / "models" / "pyannet.msgpack"), device="cpu")
    emb = EmbeddingModel.from_pretrained(str(FILES / "models" / "xvector.npz"), device="cpu")
    engine = MultiStreamEngine(seg, emb, batch_size=3, **ENGINE_KW)
    session = MultiStreamSession(engine, tau_active=0.45, collect_audio=False)
    before = session.state
    with pytest.raises(ValueError, match="'audio'"):
        session.restore(FILES / "session.msgpack")
    (tmp_path / "m.msgpack").write_bytes((FILES / "models" / "pyannet.msgpack").read_bytes())
    with pytest.raises(ValueError, match="checkpoint field"):
        session.restore(tmp_path / "m.msgpack")
    assert session.state is before


# --------------------------------------------------------------------- #
# training checkpoints
# --------------------------------------------------------------------- #
def _named(state):
    out = {n: p.detach().numpy() for n, p in state.module.named_parameters()}
    if state.prototypes is not None:
        out["prototypes"] = state.prototypes.detach().numpy()
    return out


def test_committed_training_checkpoint_resumes(stored):
    """diart_tpu's trainer directory: ``latest_checkpoint`` takes its
    ``.msgpack``; the port restores it into a template made from the
    PyanNet file and takes 2 steps: every parameter within 2 x lr a step of
    diart_tpu's after its 2 more (Adam's normalized step magnifies rounding
    where |g| is near eps: ``test_torch_train.py``)."""
    lr = float(stored["train:lr"])
    assert latest_checkpoint(FILES / "train") == FILES / "train" / "step_00000002.msgpack"
    model = SegmentationModel.from_pretrained(str(FILES / "models" / "pyannet.msgpack"), device="cpu")
    state, opt = make_train_state(model, learning_rate=lr)
    state = restore_train_state(FILES / "train", state)
    assert state.step == 2
    assert all(float(s["step"]) == 2 for s in opt.state.values()) and len(opt.state) == len(opt.param_groups[0]["params"])
    waves, targets = (torch.from_numpy(stored[k]) for k in ("train:waves", "train:targets"))
    for _ in range(2):
        state, _ = train_step(lambda m, x: m(x), opt, state, waves, targets)
    after = flatten_flax(state.module, flaxio.loads((FILES / "train_after.msgpack").read_bytes()))
    for name, value in _named(state).items():
        assert np.abs(value - after[name]).max() <= 2 * lr * 2, name


def _jax_seg_trainer(jseg, waves, targets):
    apply_fn = jseg.apply_fn()
    state, tx = jax_make_train_state(jseg.params, learning_rate=LR)
    step = jax.jit(lambda s: jax_train_step(apply_fn, tx, s, jnp.asarray(waves), jnp.asarray(targets))[0])
    return state, step


def _jax_emb_trainer(jemb, waves, labels, dim):
    embed_fn = lambda p, x: jemb.module.apply(p, x)
    state, tx = jax_make_embedding_train_state(jemb.params, 3, dim, learning_rate=LR, seed=2)
    step = jax.jit(lambda s: jax_embedding_train_step(embed_fn, tx, s, jnp.asarray(waves), jnp.asarray(labels))[0])
    return state, step


@pytest.mark.parametrize("kind", ["segmentation", "embedding"])
def test_training_resume_matches_jax(kind, session_models, tmp_path, monkeypatch):
    """Each JAX trainer takes 2 steps and saves (``save_train_state``); the
    port restores the directory into a fresh template (other weights):
    parameters, prototypes and Adam's moments equal diart_tpu's exactly
    (kernels transposed), the step 2; then both take 2 more steps: every
    parameter within 2 x lr a step of JAX's (as above). The x-vector pools
    through JAX's fused head (its plain version is the port's, as
    ``test_torch_train.py`` holds it)."""
    rng = np.random.default_rng(9)
    if kind == "segmentation":
        jseg, _ = session_models["seg"]
        waves = rng.normal(scale=0.1, size=(2, 1, 4000)).astype(np.float32)
        frames = jax.eval_shape(jseg.apply_fn(), jseg.params, jnp.asarray(waves)).shape[1]
        batch = (waves, (rng.uniform(size=(2, frames, 3)) > 0.6).astype(np.float32))
        jstate, jstep = _jax_seg_trainer(jseg, *batch)
        model = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, **SEG_KW)
        state, opt = make_train_state(model, learning_rate=LR)
        step = lambda s: train_step(lambda m, x: m(x), opt, s, *map(torch.from_numpy, batch))[0]
        flat = lambda tree: flatten_flax(state.module, tree)
    else:
        monkeypatch.setattr(jax_precision, "enabled", lambda f: f == "pallas_head")
        jemb, _ = session_models["xvector"]
        t = np.arange(8000) / 16000.0
        labels = np.arange(6) % 3
        waves = np.stack([0.3 * np.sin(2 * np.pi * (400.0 + 500.0 * l) * t) + 0.1 * rng.normal(size=8000)
                          for l in labels]).astype(np.float32)[:, None, :]
        jstate, jstep = _jax_emb_trainer(jemb, waves, labels, XVEC_KW["embedding_dim"])
        model = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=3, **XVEC_KW)
        state, opt = make_embedding_train_state(model, 3, XVEC_KW["embedding_dim"], learning_rate=LR, seed=7)
        step = lambda s: embedding_train_step(lambda m, x: m(x), opt, s, *map(torch.from_numpy, (waves, labels)))[0]
        flat = lambda tree: {**flatten_flax(state.module, tree["model"]), "prototypes": np.asarray(tree["prototypes"])}
    for _ in range(2):
        jstate = jstep(jstate)
    jax_save_train_state(tmp_path / "ckpt", jstate)
    state = restore_train_state(tmp_path / "ckpt", state)
    assert state.step == 2
    params = {id(p): n for n, p in [*state.module.named_parameters(), ("prototypes", state.prototypes)]
              if p is not None}
    adam = jstate.opt_state[0]
    mu, nu = flat(jax.tree_util.tree_map(np.asarray, adam.mu)), flat(jax.tree_util.tree_map(np.asarray, adam.nu))
    for p, s in opt.state.items():
        name = params[id(p)]
        assert float(s["step"]) == int(adam.count) == 2
        assert np.array_equal(s["exp_avg"].numpy(), mu[name]) and np.array_equal(s["exp_avg_sq"].numpy(), nu[name])
    assert len(opt.state) == len(params)
    want = flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert all(np.array_equal(v, want[n]) for n, v in _named(state).items())
    for _ in range(2):
        state, jstate = step(state), jstep(jstate)
    want = flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, value in _named(state).items():
        assert np.abs(value - want[name]).max() <= 2 * LR * 2, name


def test_restore_refuses_what_is_not_adamw(tmp_path):
    """Optimizer states that are not ``optax.adamw``'s with a constant
    learning rate (SGD with momentum, AdamW on a schedule), a segmentation
    checkpoint into an embedding trainer and a model file raise."""
    model = SegmentationModel.from_pretrained(str(FILES / "models" / "pyannet.msgpack"), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, flaxio.loads((FILES / "models" / "pyannet.msgpack").read_bytes()))
    for i, tx in enumerate((optax.sgd(1e-3, momentum=0.9), optax.adamw(optax.linear_schedule(1e-3, 0.0, 10)))):
        path = tmp_path / f"o{i}" / "step_00000000.msgpack"
        path.parent.mkdir()
        path.write_bytes(serialization.to_bytes(JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))))
        state, _ = make_train_state(model, learning_rate=LR)
        with pytest.raises(ValueError, match="optax.adamw"):
            restore_train_state(path, state)
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=0, **XVEC_KW)
    state, _ = make_embedding_train_state(emb, 3, 16)
    with pytest.raises(ValueError, match="model, prototypes"):
        restore_train_state(FILES / "train", state)
    state, _ = make_train_state(model, learning_rate=LR)
    with pytest.raises(ValueError, match="TrainState"):
        restore_train_state(FILES / "models" / "pyannet.msgpack", state)


def test_latest_checkpoint_on_a_diart_tpu_directory(tmp_path):
    """``latest.json``'s step as ``.msgpack`` when no ``.pt`` of that step
    exists (after a rollback, an older step than the highest), its ``.pt``
    when one does, the highest step of either kind without a valid
    marker."""
    src = (FILES / "train" / "step_00000002.msgpack").read_bytes()
    for step in (2, 4):
        (tmp_path / f"step_{step:08d}.msgpack").write_bytes(src)
    (tmp_path / "latest.json").write_text(json.dumps({"step": 2}))
    assert latest_checkpoint(tmp_path) == tmp_path / "step_00000002.msgpack"
    model = SegmentationModel.from_pretrained(str(FILES / "models" / "pyannet.msgpack"), device="cpu")
    state, _ = make_train_state(model, learning_rate=LR)
    state = restore_train_state(tmp_path, state)
    save_train_state(tmp_path, state._replace(step=2))
    assert latest_checkpoint(tmp_path) == tmp_path / "step_00000002.pt"
    (tmp_path / "latest.json").write_text("{}")
    assert latest_checkpoint(tmp_path) == tmp_path / "step_00000004.msgpack"
    (tmp_path / "latest.json").unlink()
    save_train_state(tmp_path, state._replace(step=6))
    (tmp_path / "latest.json").unlink()
    assert latest_checkpoint(tmp_path) == tmp_path / "step_00000006.pt"


# --------------------------------------------------------------------- #
# the stacked SincNet frontend
# --------------------------------------------------------------------- #
def _perturb(tree):
    """A distinct filterbank and waveform norm (as tests/test_engine.py's
    stacked test does)."""
    sn = tree["params"]["sincnet"]
    sn["sinc"]["low_hz"] = sn["sinc"]["low_hz"] * 1.03 + 2.0
    sn["sinc"]["band_hz"] = sn["sinc"]["band_hz"] * 0.97 + 1.0
    sn["wav_norm_scale"] = sn["wav_norm_scale"] * 1.5
    sn["wav_norm_bias"] = sn["wav_norm_bias"] + 0.1
    return tree


@pytest.fixture(scope="module")
def stack_models():
    """JAX and port PyanNet + x-vector (narrow), the x-vector's SincNet
    perturbed, on the same weights."""
    jseg = jax_registry(JaxSegmentationModel, "tpu/pyannet", init_samples=8000, **SEG_KW)
    jemb = jax_registry(JaxEmbeddingModel, "tpu/xvector", init_samples=8000, **XVEC_KW)
    jemb.params = _perturb(jax.tree_util.tree_map(np.asarray, jemb.params))
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb), **XVEC_KW)
    return (jseg, jemb), (pseg, pemb)


def _run(engine, blocks, jax_side=False):
    state = engine.init_state()
    warm = int(round(engine.duration / engine.step_duration))
    outs = []
    for i, b in enumerate(blocks):
        state, out = engine.step(state, b, run_mask=np.full((b.shape[0],), i + 1 >= warm))
        if i + 1 >= warm:
            outs.append((np.asarray(out.newest if jax_side else out.newest.cpu()),
                         np.asarray(out.aggregated if jax_side else out.aggregated.cpu())))
    return outs


# stacked against unstacked: 1e-5 (the fold conv(z s + b) = s conv(z) + b
# sum(f) rounds once more); against JAX's stacked engine: 1e-4, the
# engines' agreement (test_torch_engine.py) and tests/test_engine.py's bar.
def test_stacked_frontend_matches_unstacked_and_jax(stack_models):
    """tests/test_engine.py's stacked scenario (2 streams, 7 hops, its
    thresholds) on narrow models with distinct filterbanks: the port's
    stacked engine equals its unstacked one within 1e-5 and JAX's stacked
    engine within 1e-4."""
    (jseg, jemb), (pseg, pemb) = stack_models
    kw = dict(duration=2.0, step=0.5, latency=0.5, tau_active=0.6, rho_update=0.1, delta_new=0.7,
              max_speakers=8, sample_rate=16000, batch_size=2)
    rng = np.random.default_rng(7)
    blocks = [(0.1 * rng.normal(size=(2, 8000))).astype(np.float32) for _ in range(7)]
    stacked = MultiStreamEngine(pseg, pemb, precision=Precision(stack_frontend=True), **kw)
    plain = MultiStreamEngine(pseg, pemb, **kw)
    assert stacked._stacked is not None and plain._stacked is None
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb,
                                precision=jax_precision.Precision(stack_frontend=True), **kw)
    assert jeng._stacked
    got, want, jax_out = _run(stacked, blocks), _run(plain, blocks), _run(jeng, blocks, jax_side=True)
    for (sn, sa), (pn, pa), (jn, ja) in zip(got, want, jax_out):
        np.testing.assert_allclose(sn, pn, atol=1e-5)
        np.testing.assert_allclose(sa, pa, atol=1e-5)
        np.testing.assert_allclose(sn, jn, atol=1e-4)
        np.testing.assert_allclose(sa, ja, atol=1e-4)
    with torch.no_grad():
        wave = torch.from_numpy(np.stack(blocks[:4], axis=1).reshape(2, 1, -1))
        seg_pooled, emb_pooled = stacked._stacked_frontend(wave)
        assert torch.allclose(pseg(wave, sinc_pooled=seg_pooled), pseg(wave), atol=1e-5)
        assert torch.allclose(pemb.trunk(wave, sinc_pooled=emb_pooled), pemb.trunk(wave), atol=1e-5)


def test_stack_frontend_engages_only_when_it_should(stack_models, session_models):
    """Off by default (as JAX's); on, identical filterbanks do not stack,
    nor a VAD engine, a mel embedding or another geometry; ``parse`` and
    ``from_dict`` keep the switch."""
    _, (pseg, pemb) = stack_models
    on = Precision(stack_frontend=True)
    kw = dict(ENGINE_KW, batch_size=1)
    assert Precision().stack_frontend is False
    assert MultiStreamEngine(pseg, pemb, **kw)._stacked is None
    assert MultiStreamEngine(pseg, pemb, precision=on, **kw)._stacked is not None
    same = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=0, **XVEC_KW)
    same.module.sincnet.load_state_dict(pseg.module.sincnet.state_dict())
    assert MultiStreamEngine(pseg, same, precision=on, **kw)._stacked is None
    assert MultiStreamEngine(pseg, None, precision=on, **kw)._stacked is None
    assert MultiStreamEngine(pseg, session_models["ecapa"][1], precision=on, **kw)._stacked is None
    other = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=0, **XVEC_KW)
    other.module.sincnet.sinc.stride = 5
    assert MultiStreamEngine(pseg, other, precision=on, **kw)._stacked is None
    assert Precision.parse("stack_frontend").stack_frontend is True
    jax_dict = jax_precision.Precision(stack_frontend=True).as_dict()
    assert Precision.from_dict(jax_dict).stack_frontend is True
    assert Precision.from_dict(on.as_dict()) == on
