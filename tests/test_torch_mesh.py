"""The port's stream-parallel scale-out (``diart_tpu_torch.parallel.mesh``,
the sharded engine, data-parallel training) against one process and
against diart_tpu, on the CPU.

The counterparts of ``tests/test_mesh.py`` (the mesh helpers),
``tests/test_engine.py``'s ``TestEngineSharding`` (8 streams over 4 CPU
shard slots, with warm-up, a paused stream and a slot reset),
``tests/test_dcn.py`` (two processes in a ``gloo`` group, 2 slots each)
and ``tests/test_models.py``'s sharded training step (two ranks of 4
samples against one process of 8, and against JAX's sharded loss on
conftest's virtual CPU devices). Streams are independent, so a sharded run
must equal the unsharded one up to f32 summation order: scores and centers
within rtol/atol 1e-5 (``tests/test_dcn.py``'s), RTTM text identical.
Every subprocess has a timeout, so a hung rendezvous fails its test.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diart_tpu.precision as jax_precision
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu.parallel import MultiStreamSession as JaxMultiStreamSession
from diart_tpu.train import aam_softmax_loss as jax_aam_softmax_loss
from diart_tpu.train import embedding_train_step as jax_embedding_train_step
from diart_tpu.train import make_embedding_train_state as jax_make_embedding_train_state
from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, MultiStreamSession
from diart_tpu_torch.parallel import Sharded, StreamsMesh, mesh as mesh_mod, streams_mesh
from diart_tpu_torch.train import DataParallel

import torch_mesh_child as child
from test_torch_families import jax_registry
from test_torch_session import DIAR_KW, models  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, HOPS, STEP_SAMPLES = 8, 12, 4000


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_group(monkeypatch):
    """A process with no group and no coordinator configured."""
    monkeypatch.setattr(mesh_mod, "_distributed_ready", False)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: False)
    for var in ("DIART_TPU_COORDINATOR", "DIART_TPU_NUM_PROCESSES", "DIART_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


# ----------------------------------------------------------------------- #
# the mesh helpers (tests/test_mesh.py)


def test_noop_without_coordinator(no_group):
    assert mesh_mod.initialize_distributed() is False


def _record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_env_configuration_reaches_init_process_group(no_group, monkeypatch):
    calls = _record_init(monkeypatch)
    monkeypatch.setenv("DIART_TPU_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("DIART_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("DIART_TPU_PROCESS_ID", "2")
    assert mesh_mod.initialize_distributed() is True
    assert calls == [dict(backend="nccl", init_method="tcp://10.0.0.1:8476", world_size=4, rank=2)]
    # idempotent: a second call does not initialize again
    assert mesh_mod.initialize_distributed() is True
    assert len(calls) == 1


def test_explicit_args_beat_env(no_group, monkeypatch):
    calls = _record_init(monkeypatch)
    monkeypatch.setenv("DIART_TPU_COORDINATOR", "wrong:1")
    monkeypatch.setenv("DIART_TPU_NUM_PROCESSES", "9")
    assert mesh_mod.initialize_distributed("right:2", num_processes=1, process_id=0, device="cpu")
    assert calls == [dict(backend="gloo", init_method="tcp://right:2", world_size=1, rank=0)]


def test_coordinator_without_process_count_raises(no_group, monkeypatch):
    _record_init(monkeypatch)
    with pytest.raises(ValueError, match="DIART_TPU_NUM_PROCESSES"):
        mesh_mod.initialize_distributed("host:1")


def test_streams_mesh_cpu_slots_only_when_asked(no_group, monkeypatch):
    """CPU shard slots exist where the caller asks for ``device="cpu"``;
    asked for CUDA devices that are missing, the helpers raise instead of
    downgrading to the CPU."""
    mesh = streams_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mesh_mod.provision_devices(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        streams_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        streams_mesh()
    # an explicit list may repeat a device: two shards on one device
    assert streams_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_mesh_layout_matches_jax_named_sharding():
    """The global stream axis is cut process-major, then by local slot, in
    equal contiguous slices: within a process the slices JAX's
    ``NamedSharding(mesh, P("streams"))`` gives its devices."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    jmesh = Mesh(np.array(jax.devices()[:4]), ("streams",))
    arr = jax.device_put(np.arange(8), NamedSharding(jmesh, P("streams")))
    starts = sorted(s.index[0].start or 0 for s in arr.addressable_shards)
    mesh = StreamsMesh((torch.device("cpu"),) * 4)
    assert [mesh.shard_size(8) * k for k in range(4)] == starts
    two = StreamsMesh((torch.device("cpu"),) * 2, rank=1, world_size=2)
    assert two.size == 4 and two.local_slice(8) == slice(4, 8)
    with pytest.raises(ValueError, match="divisible"):
        two.shard_size(6)


# ----------------------------------------------------------------------- #
# the sharded engine against the unsharded one and against JAX's


def _blocks(seed=21, hops=HOPS):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=(hops, BATCH, STEP_SAMPLES)).astype(np.float32)


def _schedule(hops=HOPS):
    """Per hop: (present, slots reset after the hop). Stream 1 pauses at hop
    4; slots 0 and 5 (two shards) are recycled after hop 6."""
    plan = []
    for i in range(hops):
        present = np.ones(BATCH, bool)
        if i == 4:
            present[1] = False
        plan.append((present, [0, 5] if i == 6 else []))
    return plan


def _engines(models, **kw):
    _, (pseg, pemb) = models
    single = MultiStreamEngine(pseg, pemb, batch_size=BATCH, **DIAR_KW, **kw)
    sharded = MultiStreamEngine(pseg, pemb, batch_size=BATCH, mesh=streams_mesh(4, device="cpu"),
                                **DIAR_KW, **kw)
    return single, sharded


def test_sharded_engine_matches_unsharded(models, no_group):
    single, sharded = _engines(models)
    assert sharded.batch_size == BATCH and sharded.shard_bounds == [(0, 2), (2, 4), (4, 6), (6, 8)]
    s1, s4 = single.init_state(), sharded.init_state()
    assert isinstance(s4.centers, Sharded) and len(s4.centers) == 4
    assert s4.centers.shape == s1.centers.shape and s4.audio.dtype == s1.audio.dtype
    warmup = int(round(single.duration / single.step_duration))
    seen = np.zeros(BATCH, int)
    for blk, (present, resets) in zip(_blocks(), _schedule()):
        seen[present] += 1
        run = present & (seen >= warmup)
        s1, o1 = single.step(s1, blk, present, run)
        s4, o4 = sharded.step(s4, blk, present, run)
        for got, want in ((o4.aggregated, o1.aggregated), (o4.newest, o1.newest), (s4.centers, s1.centers)):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(o4.chunk_index.cpu(), o1.chunk_index)
        if resets:
            mask = np.isin(np.arange(BATCH), resets)
            s1, s4 = single.reset_streams(s1, mask), sharded.reset_streams(s4, mask)
            seen[mask] = 0
            assert not s4.initialized.cpu()[mask].any()
    # hyper-parameters reach every shard; the probe joins the shards
    sharded.set_hyperparameters(tau_active=0.3)
    assert all(float(sh._hparams[0]) == pytest.approx(0.3) for sh in sharded._shards)
    single.set_hyperparameters(tau_active=0.3)
    blk = _blocks(seed=3, hops=1)[0]
    for got, want in zip(sharded.probe_frame_scores(s4, blk), single.probe_frame_scores(s1, blk)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _texts(session, blocks, route="rttm"):
    texts = []
    for blk, (present, resets) in zip(blocks, _schedule(len(blocks))):
        if route == "rttm":
            texts.append(session.push_rttm(blk, present))
        else:
            texts.append([None if o is None else o[0].to_rttm() for o in session.push(blk, present)])
        if resets:
            session.reset_slots(resets, uris=[f"fresh{i}" for i in resets], shifts=[1.5] * len(resets))
    return texts


@pytest.mark.parametrize("route", ["rttm", "annotation"])
def test_sharded_session_text_matches_unsharded(models, no_group, route):
    single, sharded = _engines(models)
    blocks = _blocks()
    want = _texts(MultiStreamSession(single, tau_active=0.45, collect_audio=False), blocks, route)
    got = _texts(MultiStreamSession(sharded, tau_active=0.45, collect_audio=False), blocks, route)
    assert any(t for hop in want for t in hop)
    assert got == want


def test_sharded_session_checkpoint_moves_between_layouts(models, no_group, tmp_path):
    """A checkpoint holds the whole stream axis: saved from the sharded
    session it resumes on an unsharded one, and back, with the same text."""
    single, sharded = _engines(models)
    blocks = _blocks()
    want = _texts(MultiStreamSession(single, tau_active=0.45, collect_audio=False), blocks)
    half = len(blocks) // 2
    first = MultiStreamSession(sharded, tau_active=0.45, collect_audio=False)
    texts = _texts(first, blocks[:half])
    first.save(tmp_path / "a.pt")
    second = MultiStreamSession(single, tau_active=0.45, collect_audio=False)
    second.restore(tmp_path / "a.pt")
    second.save(tmp_path / "b.pt")
    third = MultiStreamSession(sharded, tau_active=0.45, collect_audio=False)
    third.restore(tmp_path / "b.pt")
    assert isinstance(third.state.ring, Sharded)
    for blk, (present, resets) in list(zip(blocks, _schedule()))[half:]:
        texts.append(third.push_rttm(blk, present))
        if resets:
            third.reset_slots(resets, uris=[f"fresh{i}" for i in resets], shifts=[1.5] * len(resets))
    assert texts == want


def test_sharded_engine_matches_jax_sharded(models, no_group):
    """The port's sharded session against JAX's sharded engine on 4 of
    conftest's 8 virtual CPU devices: aggregated scores within the port's
    engine tolerance (1e-4, ``tests/test_torch_engine.py``), RTTM text
    identical at every hop."""
    from jax.sharding import Mesh

    (jseg, jemb), _ = models
    jmesh = Mesh(np.array(jax.devices()[:4]), ("streams",))
    _, sharded = _engines(models)
    jeng = JaxMultiStreamEngine(jseg, jemb, batch_size=BATCH, mesh=jmesh, **DIAR_KW)
    blocks = _blocks(hops=8)
    plan = _schedule(8)
    warmup = int(round(sharded.duration / sharded.step_duration))
    jstate, pstate = jeng.init_state(), sharded.init_state()
    seen = np.zeros(BATCH, int)
    for blk, (present, _) in zip(blocks, plan):
        seen[present] += 1
        run = present & (seen >= warmup)
        jstate, jout = jeng.step(jstate, blk, present, run)
        pstate, pout = sharded.step(pstate, blk, present, run)
        np.testing.assert_allclose(pout.aggregated.cpu().numpy(), np.asarray(jout.aggregated), atol=1e-4)
    jses = JaxMultiStreamSession(JaxMultiStreamEngine(jseg, jemb, batch_size=BATCH, mesh=jmesh, **DIAR_KW),
                                 tau_active=0.45, collect_audio=False)
    pses = MultiStreamSession(sharded, tau_active=0.45, collect_audio=False)
    want = [jses.push_rttm(blk, present) for blk, (present, _) in zip(blocks, plan)]
    got = [pses.push_rttm(blk, present) for blk, (present, _) in zip(blocks, plan)]
    assert any(t for hop in want for t in hop)
    assert got == want


# ----------------------------------------------------------------------- #
# two processes in a gloo group (tests/test_dcn.py) and data-parallel
# training (tests/test_models.py's sharded step)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_xvector():
    return jax_registry(JaxEmbeddingModel, "tpu/xvector", init_samples=child.TRAIN_SAMPLES, **child.EMB_KW)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_xvector):
    """Both ranks' dumps, after the x-vector weights (JAX's, carried over)
    were written for them."""
    out = tmp_path_factory.mktemp("ranks")
    tree = jax.tree_util.tree_map(np.asarray, jax_xvector.params)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree, **child.EMB_KW)
    torch.save(pemb.module.state_dict(), out / "xvector.pt")
    env = dict(os.environ, DIART_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", DIART_TPU_NUM_PROCESSES="2",
               OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen([sys.executable, os.path.join("tests", "torch_mesh_child.py"), str(out)], cwd=REPO,
                         env=dict(env, DIART_TPU_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)
    ]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            results.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, stdout, stderr in results:
        assert rc == 0, f"rank failed:\n{stdout}\n{stderr[-4000:]}"
        assert "ok" in stdout
    return out, [np.load(out / f"rank{r}.npz") for r in (0, 1)]


def test_two_processes_match_one(models, two_ranks):
    """Two ranks of two CPU slots (the global 4-shard mesh), each driving
    its half of the streams: their rows, joined in rank order, equal one
    process's unsharded run."""
    out, dumps = two_ranks
    seg, emb = child.models(out)
    engine = MultiStreamEngine(seg, emb, batch_size=child.BATCH, **child.ENGINE_KW)
    state, res = child.run_engine(engine, slice(0, child.BATCH))
    assert [tuple(d["rows"]) for d in dumps] == [(0, 4), (4, 8)]
    agg = np.concatenate([d["agg"] for d in dumps])
    centers = np.concatenate([d["centers"] for d in dumps])
    np.testing.assert_allclose(agg, res.aggregated.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(centers, state.centers.numpy(), rtol=1e-5, atol=1e-5)


def _norm_close(got, want, name, top):
    """Norm-wise within 1e-5 (sums over a half batch, then across the
    ranks). A tensor whose gradient is zero but for rounding (a scale or a
    bias before a normalization: a norm under 1e-6 of ``top``, the largest
    tensor's) within 1e-5 of ``top``, as tests/test_torch_train.py holds
    such tensors."""
    norm = np.linalg.norm(want)
    bound = 1e-5 * (norm if norm >= 1e-6 * top else top)
    assert np.linalg.norm(got - want) <= bound, name


@pytest.mark.parametrize("kind", ["emb", "seg"])
def test_data_parallel_step_matches_one_process(two_ranks, kind):
    """Two gloo ranks of 4 samples against one process of 8: the loss within
    rtol 1e-5 (JAX's tolerance for its sharded step), every gradient
    norm-wise within 1e-5, every parameter after the step within 2 x lr
    (Adam's normalized step magnifies rounding where |g| is near eps, the
    rule of tests/test_torch_train.py); both ranks hold the same step.
    Only rank 0 wrote its checkpoint."""
    out, dumps = two_ranks
    seg, emb = child.models(out)
    want, _ = child.train_steps(seg, emb)
    np.testing.assert_allclose(dumps[0][f"{kind}_loss"], want[f"{kind}_loss"], rtol=1e-5)
    top = max(np.linalg.norm(v) for n, v in want.items() if n.startswith(f"{kind}_grad/"))
    for name in want:
        if not name.startswith(f"{kind}_"):
            continue
        for d in dumps:
            if "grad/" in name:
                _norm_close(d[name], want[name], name, top)
            elif "param/" in name:
                np.testing.assert_allclose(d[name], want[name], rtol=0, atol=2 * child.LR, err_msg=name)
        np.testing.assert_array_equal(dumps[0][name], dumps[1][name])
    assert list((out / "ckpt0").glob("step_*.pt")) and not (out / "ckpt1").exists()


def test_data_parallel_loss_matches_jax_sharded(two_ranks, jax_xvector, monkeypatch):
    """The ranks' AAM loss against JAX's data-parallel step (the batch
    sharded over a ``dp`` axis of 8 virtual devices, ``tests/test_models.py``)
    on the same weights, prototypes and batch: rtol 1e-5. JAX runs its fused
    head (interpret mode), whose plain version the port's head is
    (``tests/test_torch_train.py``)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    _, dumps = two_ranks
    monkeypatch.setattr(jax_precision, "enabled", lambda f: f == "pallas_head")
    module = jax_xvector.module
    embed_fn = lambda p, w: module.apply(p, w)
    waves, labels = (t.numpy() for t in child.train_data())
    jstate, tx = jax_make_embedding_train_state(jax_xvector.params, child.CLASSES, child.EMB_KW["embedding_dim"],
                                                learning_rate=child.LR, seed=2)
    # the ranks' prototypes come from the port's seeded generator
    _, emb = child.models(two_ranks[0])
    from diart_tpu_torch.train import make_embedding_train_state

    state, _ = make_embedding_train_state(emb, child.CLASSES, child.EMB_KW["embedding_dim"], seed=2)
    params = dict(jstate.params, prototypes=jnp.asarray(state.prototypes.detach().numpy()))
    jstate = jstate._replace(params=params)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    dp, rep = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    step = jax.jit(lambda s, w, l: jax_embedding_train_step(embed_fn, tx, s, w, l),
                   in_shardings=(rep, dp, dp), out_shardings=(rep, rep))
    _, loss = step(jax.device_put(jstate, rep), jax.device_put(jnp.asarray(waves), dp),
                   jax.device_put(jnp.asarray(labels), dp))
    np.testing.assert_allclose(float(dumps[0]["emb_loss"]), float(loss), rtol=1e-5)
    plain = jax_aam_softmax_loss(embed_fn(params["model"], jnp.asarray(waves)), jnp.asarray(labels),
                                 params["prototypes"])
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)


def test_data_parallel_needs_one_device_a_process():
    with pytest.raises(ValueError, match="one device a process"):
        DataParallel.of(StreamsMesh((torch.device("cpu"),) * 2))
    one = DataParallel.of(StreamsMesh((torch.device("cpu"),), rank=1, world_size=2))
    waves = torch.arange(8.0)
    assert torch.equal(one.local(waves)[0], waves[4:])
    with pytest.raises(ValueError, match="divisible"):
        one.local(torch.arange(7.0))
