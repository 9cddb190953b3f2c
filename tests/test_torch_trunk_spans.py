"""The hop's span tree and the device event inside the step's embedding
phase (``diart_tpu_torch.tracing``, ``MultiStreamEngine._embed``) on the
CPU.

For every embedding family the engine serves (ResNet34 through the kaldi
frame ring, ECAPA through the speechbrain ring, the SincNet x-vector from
the waveform) a hop records the step's three phases under the dispatch and
nothing inside a phase. Off, nothing records and no timing event is made.
On a card the step records a fifth event where the trunk returns, read as
``DevicePhases.trunk_ms``; the CPU has no events, so stand-in events hold
the bookkeeping and the event's place in the step, and ``DevicePhases``
still builds from the four phase boundaries alone.
"""

import numpy as np
import pytest
import torch

from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, MultiStreamSession, SegmentationModel
from diart_tpu_torch import tracing

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
FAMILIES = {
    "tpu/resnet34": dict(embedding_dim=16, base_channels=4),
    "tpu/ecapa": dict(embedding_dim=16, channels=32),
    "tpu/xvector": dict(embedding_dim=16),
}
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4)
TAU = 0.45
BATCH, STEP_SAMPLES = 2, 4000


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def segmentation():
    return SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, **SEG_KW)


def _engine(segmentation, name):
    emb = EmbeddingModel.from_registry(name, device="cpu", seed=4, **FAMILIES[name])
    return MultiStreamEngine(segmentation, emb, batch_size=BATCH, tau_active=TAU, rho_update=0.05, **ENGINE_KW)


def _blocks(seed, hops):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, (BATCH, STEP_SAMPLES)).astype(np.float32) for _ in range(hops)]


def _primed(engine):
    session = MultiStreamSession(engine, tau_active=TAU, collect_audio=False)
    for block in _blocks(1, session.warmup_blocks - 1):
        session.push_rttm(block)
    return session


def test_off_records_nothing_and_makes_no_event(segmentation, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    session = _primed(_engine(segmentation, "tpu/resnet34"))
    for block in _blocks(2, 2):
        pending = session.push_begin(block)
        assert pending.hop is None
        session.push_finish_rttm(pending)
    assert tracing.device_marks(torch.device("cuda")) is tracing.NO_MARKS
    tracing.NO_MARKS.mark_trunk()
    assert made == []


class _Ordered:
    """A timing event that keeps the order it was recorded in; elapsed time
    is 10 ms a recorded event between two."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream):
        self.t = len(_Ordered.log)
        _Ordered.log.append(self)

    def elapsed_time(self, later):
        return 10.0 * (later.t - self.t)


@pytest.fixture
def ordered_events(monkeypatch):
    _Ordered.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Ordered)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")


def test_device_phases_with_and_without_the_trunk_event(ordered_events):
    owner = object()
    cuda = torch.device("cuda", 0)
    with tracing.recording() as record:
        with tracing.hop("session.dispatch", owner) as key:
            marks = tracing.device_marks(cuda)
            marks.mark()
            marks.mark()
            marks.mark_trunk()
            marks.mark()
            marks.mark()
        with tracing.hop("session.dispatch", owner) as bare:
            marks = tracing.device_marks(cuda)
            for _ in range(4):
                marks.mark()
        tracing.settle(key)
        tracing.settle(bare)
    assert record.phases == [tracing.DevicePhases(key, None, 10.0, 20.0, 10.0, 10.0),
                             tracing.DevicePhases(bare, None, 10.0, 10.0, 10.0)]
    assert record.phases[1].trunk_ms is None
    assert tracing.DevicePhases(key, 0, 1.0, 2.0, 3.0) == (key, 0, 1.0, 2.0, 3.0, None)


@pytest.mark.parametrize("name", ["tpu/resnet34", "tpu/xvector"])
def test_step_records_the_trunk_event_inside_the_embedding(segmentation, ordered_events, monkeypatch, name):
    """A step whose device marks are a card's (stand-in events): five
    events, the trunk's after the segmentation's and before the
    embedding's, read at the harvest."""
    engine = _engine(segmentation, name)
    session = _primed(engine)
    marks = tracing.device_marks
    monkeypatch.setattr(tracing, "device_marks", lambda device, shard=None: marks(torch.device("cuda", 0), shard))
    with tracing.recording() as record:
        session.push_rttm(_blocks(3, 1)[0])
    (phases,) = record.phases
    assert len(_Ordered.log) == 5
    # events in order: start, after segmentation, trunk, after embedding, end
    assert phases.segmentation_ms == 10.0 and phases.trunk_ms == 10.0
    assert phases.embedding_ms == 20.0 and phases.clustering_ms == 10.0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_hop_records_the_phase_tree_and_one_trunk_event(segmentation, ordered_events, monkeypatch, name):
    """A hop of each family on the tree the readers take: the step's three
    phases under the dispatch, then the harvest's two spans, nothing
    recorded inside a phase; with stand-in events, one trunk event read."""
    engine = _engine(segmentation, name)
    assert (engine._fring is not None) == (name != "tpu/xvector")
    session = _primed(engine)
    marks = tracing.device_marks
    monkeypatch.setattr(tracing, "device_marks", lambda device, shard=None: marks(torch.device("cuda", 0), shard))
    with tracing.recording() as record:
        texts = session.push_rttm(_blocks(2, 1)[0])
    assert all(isinstance(t, str) for t in texts)
    assert [s.name for s in record.spans] == ["step.segmentation", "step.embedding", "step.clustering",
                                              "session.dispatch", "session.wait_card", "session.assemble"]
    dispatch = record.spans[3]
    phases = record.spans[:3]
    assert all(s.parent == dispatch.id and s.hop == dispatch.hop and s.shard is None for s in phases)
    assert not any(s.parent in {p.id for p in phases} for s in record.spans)
    assert len({s.id for s in record.spans}) == 6
    (hop,) = record.phases
    assert hop.hop == dispatch.hop and hop.trunk_ms is not None
    assert len(_Ordered.log) == 5  # the four phase boundaries and the trunk's return
