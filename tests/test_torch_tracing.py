"""The serving hop's span recorder (``diart_tpu_torch.tracing``) on the CPU.

Off, a hop records nothing and every site returns the shared no-op. On, a
hop gives the span tree the module documents (``session.dispatch`` over the
step's three phases, then ``session.wait_card`` and ``session.assemble``),
nested, in order and under one hop key; a pipelined cohort scheduler's
dispatch spans lie on its thread and its harvests' on theirs, each hop's
inside its ``HopTiming`` (one clock); recording changes no output; a
sharded engine records each shard's phases. The CPU has no device phases;
their bookkeeping is held here with stand-in events.
"""

import threading

import numpy as np
import pytest
import torch

from diart_tpu_torch import CohortScheduler, EmbeddingModel, MultiStreamEngine, MultiStreamSession, SegmentationModel
from diart_tpu_torch import tracing
from diart_tpu_torch.parallel import streams_mesh

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4)
TAU = 0.45
BATCH, STEP_SAMPLES = 2, 4000
PHASES = ("step.segmentation", "step.embedding", "step.clustering")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, **SEG_KW)
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=4, **EMB_KW)
    return seg, emb


def _engine(models, vad=False, batch=BATCH, mesh=None):
    seg, emb = models
    return MultiStreamEngine(seg, None if vad else emb, batch_size=batch, tau_active=TAU, rho_update=0.05,
                             mesh=mesh, **ENGINE_KW)


def _blocks(seed, hops, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, (batch, STEP_SAMPLES)).astype(np.float32) for _ in range(hops)]


def _primed(engine):
    """A session past its warm-up: its next hop emits for every stream."""
    session = MultiStreamSession(engine, tau_active=TAU, collect_audio=False)
    for block in _blocks(1, session.warmup_blocks - 1, engine.batch_size):
        assert session.push_rttm(block) == [None] * engine.batch_size
    return session


def test_off_records_nothing(models):
    session = _primed(_engine(models))
    # what the session holds, and how much of it: no per-hop history grows
    held = lambda: {k: (type(v), len(v) if isinstance(v, (list, tuple, dict, np.ndarray)) else None)
                    for k, v in vars(session).items()}
    before = held()
    for block in _blocks(2, 3):
        pending = session.push_begin(block)
        assert pending.hop is None
        assert all(isinstance(t, str) for t in session.push_finish_rttm(pending))
    assert held() == before
    assert tracing.span("step.segmentation") is tracing.NOOP
    assert tracing.span("session.assemble", hop=tracing.HopKey(0, 0)) is tracing.NOOP
    assert tracing.hop("session.dispatch", session) is tracing.NOOP
    assert tracing.device_marks(torch.device("cuda")) is tracing.NO_MARKS
    with tracing.NOOP as key:
        assert key is None


@pytest.mark.parametrize("vad", [False, True], ids=["xvector", "vad"])
def test_one_hop_span_tree(models, vad):
    session = _primed(_engine(models, vad=vad))
    with tracing.recording() as record:
        texts = session.push_rttm(_blocks(2, 1)[0])
    assert all(isinstance(t, str) for t in texts)
    names = [s.name for s in record.spans]
    phases = [p for p in PHASES if not (vad and p == "step.embedding")]
    # spans are kept in the order they closed
    assert names == phases + ["session.dispatch", "session.wait_card", "session.assemble"]
    by = {s.name: s for s in record.spans}
    dispatch = by["session.dispatch"]
    assert {s.hop for s in record.spans} == {tracing.HopKey(0, 0)}
    assert {s.thread for s in record.spans} == {threading.get_ident()}
    assert len({s.id for s in record.spans}) == len(names)
    assert dispatch.parent is None and by["session.wait_card"].parent is None
    assert by["session.assemble"].parent is None
    chain = [by[p] for p in phases]
    for s in chain:
        assert s.parent == dispatch.id and s.shard is None
        assert dispatch.start <= s.start <= s.end <= dispatch.end
    for a, b in zip(chain, chain[1:]):
        assert a.end <= b.start
    assert dispatch.end <= by["session.wait_card"].start <= by["session.wait_card"].end
    assert by["session.wait_card"].end <= by["session.assemble"].start <= by["session.assemble"].end
    assert record.phases == []


def test_pipelined_cohorts_threads_and_clock(models):
    """K=2, pipelined: dispatches on the scheduler's thread, harvests on the
    cohorts' harvest threads, and every hop's spans inside its HopTiming's
    [dispatched, done]: the spans are on the scheduler's clock."""
    scheduler = CohortScheduler(_engine(models), 2, tau_active=TAU)
    blocks = _blocks(5, 8)
    get_blocks = lambda j, p: (blocks[p % len(blocks)], None)
    scheduler.prime(get_blocks)
    with tracing.recording() as record:
        timings = scheduler.run(get_blocks, 3, pipelined=True, start_delay=0.0)
    assert len(timings) == 6
    here = threading.get_ident()
    hops = {}
    for s in record.spans:
        hops.setdefault(s.hop, []).append(s)
    # a session's number is its order of first dispatch: cohort j's is j
    assert set(hops) == {tracing.HopKey(t.cohort, t.period) for t in timings}
    for t in timings:
        spans = hops[tracing.HopKey(t.cohort, t.period)]
        assert sorted(s.name for s in spans) == sorted(PHASES + ("session.dispatch", "session.wait_card",
                                                                  "session.assemble"))
        for s in spans:
            assert t.dispatched <= s.start <= s.end <= t.done
            on_scheduler = s.name == "session.dispatch" or s.name in PHASES
            assert (s.thread == here) == on_scheduler, s
    harvest_threads = {s.thread for s in record.spans if s.name == "session.assemble"}
    assert here not in harvest_threads and len(harvest_threads) >= 1


@pytest.mark.parametrize("vad", [False, True], ids=["xvector", "vad"])
def test_outputs_bitwise_with_recording(models, vad):
    engine = _engine(models, vad=vad)
    blocks = _blocks(7, 6)

    def run(on):
        session = MultiStreamSession(engine, tau_active=TAU, collect_audio=False)
        scores, texts = [], []
        with tracing.recording() if on else tracing.NOOP:
            for block in blocks:
                pending = session.push_begin(block)
                if pending is None:
                    continue
                scores.append(pending.device_aggregated.clone())
                texts.append(session.push_finish_rttm(pending))
            annotations = session.push(blocks[0])
        return scores, texts, [a[0].to_rttm() for a in annotations], session.state

    off, on = run(False), run(True)
    assert len(off[0]) == len(on[0]) > 0
    for a, b in zip(off[0], on[0], strict=True):
        assert torch.equal(a, b)
    assert off[1] == on[1] and off[2] == on[2]
    for a, b in zip(off[3], on[3], strict=True):
        for x, y in zip(*(t.values() if isinstance(t, dict) else [t] for t in (a, b)), strict=True):
            assert torch.equal(x, y)


def test_sharded_engine_records_each_shard(models):
    engine = _engine(models, batch=4, mesh=streams_mesh(devices=["cpu", "cpu"]))
    session = _primed(engine)
    with tracing.recording() as record:
        texts = session.push_rttm(_blocks(2, 1, batch=4)[0])
    assert all(isinstance(t, str) for t in texts)
    dispatch = next(s for s in record.spans if s.name == "session.dispatch")
    steps = [s for s in record.spans if s.name in PHASES]
    assert sorted((s.shard, s.name) for s in steps) == sorted((k, p) for k in (0, 1) for p in PHASES)
    assert all(s.parent == dispatch.id and s.hop == dispatch.hop for s in steps)
    # the shards' steps are queued one after the other
    ends = {k: max(s.end for s in steps if s.shard == k) for k in (0, 1)}
    assert ends[0] <= min(s.start for s in steps if s.shard == 1)
    assert record.phases == []


def test_no_device_phases_on_cpu(models):
    session = _primed(_engine(models))
    with tracing.recording() as record:
        for block in _blocks(3, 3):
            session.push_rttm(block)
        with tracing.hop("session.dispatch", session):
            assert tracing.device_marks(torch.device("cpu")) is tracing.NO_MARKS
    assert len([s for s in record.spans if s.name == "session.assemble"]) == 3
    assert record.phases == []


class _StandInEvent:
    """A timing event read from the host clock, for the bookkeeping test."""

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream):
        self.t = len(_StandInEvent.log)
        _StandInEvent.log.append(stream)

    def elapsed_time(self, later):
        return float((later.t - self.t) * 10 + self.t)


def test_device_phase_bookkeeping(monkeypatch):
    """Four events a step inside a hop, read into DevicePhases once at the
    harvest; nothing outside a hop, nothing kept past the recording."""
    _StandInEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")
    cuda = torch.device("cuda", 0)
    owner = object()
    with tracing.recording() as record:
        assert tracing.device_marks(cuda) is tracing.NO_MARKS
        with tracing.hop("session.dispatch", owner) as key:
            for shard in (0, 1):
                marks = tracing.device_marks(cuda, shard)
                for _ in range(4):
                    marks.mark()
        tracing.settle(key)
        tracing.settle(key)
        with tracing.hop("session.dispatch", owner) as unharvested:
            tracing.device_marks(cuda).mark()
    assert _StandInEvent.log == ["stream of cuda:0"] * 9
    assert record.phases == [tracing.DevicePhases(key, 0, 10.0, 11.0, 12.0),
                             tracing.DevicePhases(key, 1, 14.0, 15.0, 16.0)]
    assert unharvested == tracing.HopKey(0, 1) and record._marks == {}


def test_recordings_do_not_mix(models):
    """One recording at a time; a hop dispatched outside a recording, or in
    an earlier one, records nothing in the next."""
    session = _primed(_engine(models))
    before = session.push_begin(_blocks(2, 1)[0])
    with tracing.recording() as first:
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
        session.push_finish_rttm(before)
        stale = session.push_begin(_blocks(3, 1)[0])
    assert [s.name for s in first.spans][-1] == "session.dispatch"
    assert not any(s.name in ("session.wait_card", "session.assemble") for s in first.spans)
    with tracing.recording() as second:
        fresh = session.push_begin(_blocks(4, 1)[0])
        # the stale hop's key equals the fresh one's, (0, 0), and is not it
        assert stale.hop == fresh.hop == tracing.HopKey(0, 0)
        session.push_finish_rttm(stale)
        session.push_finish_rttm(fresh)
    assert [s.name for s in second.spans][-3:] == ["session.dispatch", "session.wait_card", "session.assemble"]
    assert len(second.spans) == 6 and {s.hop for s in second.spans} == {fresh.hop}


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_profile_records_without_a_recording(models):
    """While torch's profiler runs, the hops go to the profile's own record;
    once it has ended a hop records nothing and the record stays, until the
    next profile's first hop starts a new one. An open recording takes
    precedence."""
    session = _primed(_engine(models))
    blocks = _blocks(6, 5)
    with _profile():
        for block in blocks[:2]:
            session.push_rttm(block)
    first = tracing.last_profile()
    assert first is not None
    assert sorted({s.hop for s in first.spans}) == [tracing.HopKey(0, 0), tracing.HopKey(0, 1)]
    assert sorted(s.name for s in first.spans if s.hop == tracing.HopKey(0, 1)) == sorted(
        PHASES + ("session.dispatch", "session.wait_card", "session.assemble"))
    held = len(first.spans)
    pending = session.push_begin(blocks[2])
    assert pending.hop is None and tracing.span("session.assemble") is tracing.NOOP
    session.push_finish_rttm(pending)
    assert tracing.last_profile() is first and len(first.spans) == held
    with _profile():
        with tracing.recording() as record:
            session.push_rttm(blocks[3])
        session.push_rttm(blocks[4])
    assert {s.hop for s in record.spans} == {tracing.HopKey(0, 0)} and len(record.spans) == held // 2
    second = tracing.last_profile()
    assert second is not first and len(first.spans) == held
    assert {s.hop for s in second.spans} == {tracing.HopKey(0, 0)} and len(second.spans) == held // 2
    # no hop dispatched between two profiles: they share one record
    with _profile():
        session.push_rttm(blocks[0])
    assert tracing.last_profile() is second and len(second.spans) == held


def test_profile_reads_device_phases_after_it_ends(monkeypatch):
    """A hop dispatched under the profiler and harvested once it has ended
    still has its device phases read into the profile's record."""
    _StandInEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")
    owner = object()
    with _profile():
        with tracing.hop("session.dispatch", owner) as key:
            marks = tracing.device_marks(torch.device("cuda", 0))
            for _ in range(4):
                marks.mark()
    record = tracing.last_profile()
    assert record.phases == []
    tracing.settle(tracing.HopKey(*key))  # an equal key of no hop of it reads nothing
    tracing.settle(key)
    assert record.phases == [tracing.DevicePhases(key, None, 10.0, 11.0, 12.0)] and record._marks == {}


def test_profile_one_record_across_threads():
    """Threads dispatching at once as a profile starts share one record,
    and every hop key in it is distinct."""
    import sys

    owners = [object() for _ in range(8)]
    start = threading.Barrier(len(owners))
    with tracing.hop("session.dispatch", object()):  # no profile: ends an earlier profile's record
        pass

    def dispatch(owner):
        start.wait(timeout=30)
        for _ in range(50):
            with tracing.hop("session.dispatch", owner):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=dispatch, args=(o,)) for o in owners]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.last_profile().spans
    assert len(spans) == 400 and len({s.hop for s in spans}) == 400
    assert sorted({s.hop.session for s in spans}) == list(range(8))
