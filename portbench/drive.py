"""The load generator: one general driver a traffic mode, reading only the
traffic file's parameters.

* ``closed``: one session of ``batch`` streams; hop k+1 is dispatched
  (``push_begin``) before hop k is finished (``push_finish_rttm``), so one
  hop is always queued ahead of the harvest.
* ``open``: ``CohortScheduler`` with ``cohorts`` sessions of ``batch``
  streams, pipelined, cohort j due at phase j x step / K of each period.

Both keep, for the sampled streams, the step's aggregated scores (a device
gather of their rows, queued after the step) and the RTTM text of every hop
from each stream's first chunk on, for the check. With ``spans`` on, the
harness's calls into the session (``push_begin``, ``push_finish_rttm``),
the scheduler's waits (``wait``) and the window (``window``) are timed on
the host clock into ``SPANS``: (name, start s, end s).
"""

from __future__ import annotations

import contextlib
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .cell import StreamAudio


SPANS: List[Tuple[str, float, float]] = []


@contextlib.contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPANS.append((name, t0, time.perf_counter()))


def _span(name: str, on: bool):
    return _timed(name) if on else contextlib.nullcontext()


class Capture:
    """What the timed path produced for the sampled streams: per (cohort,
    chunk) the device rows of the aggregated scores and the texts."""

    def __init__(self, sample: List[Tuple[int, int]], device):
        self.rows: Dict[int, torch.Tensor] = {}
        self.locals: Dict[int, List[int]] = {}
        for j, i in sample:
            self.locals.setdefault(j, []).append(i)
        for j, idx in self.locals.items():
            self.rows[j] = torch.as_tensor(idx, device=device)
        self.agg: Dict[Tuple[int, int], torch.Tensor] = {}
        self.texts: Dict[Tuple[int, int, int], Optional[str]] = {}

    def scores(self, cohort: int, pending) -> None:
        if pending is None or cohort not in self.rows:
            return
        chunk = int(pending.chunk_index[self.locals[cohort][0]])
        self.agg[(cohort, chunk)] = pending.device_aggregated.index_select(0, self.rows[cohort])

    def outputs(self, cohort: int, chunk: int, outputs) -> None:
        for i in self.locals.get(cohort, ()):
            self.texts[(cohort, i, chunk)] = outputs[i]

    def host(self) -> Dict[Tuple[int, int], np.ndarray]:
        return {k: v.float().cpu().numpy() for k, v in self.agg.items()}


class Session:
    """A session's dispatch and harvest as the harness calls them: timed on
    the host (``dispatch_ms``) and, with ``spans``, recorded as spans."""

    def __init__(self, session, cohort: int, capture: Capture, spans: bool):
        self.session, self.cohort, self.capture, self.spans = session, cohort, capture, spans
        # the session's own methods, bound before a scheduler's are replaced
        self._push_begin, self._push_finish_rttm = session.push_begin, session.push_finish_rttm
        self.dispatch_ms: List[float] = []

    def begin(self, blocks, present=None, rttm: bool = True):
        with _span("push_begin", self.spans):
            t0 = time.perf_counter()
            pending = self._push_begin(blocks, present, rttm)
            self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            self.capture.scores(self.cohort, pending)
        return pending

    def finish(self, pending):
        with _span("push_finish_rttm", self.spans):
            return self._push_finish_rttm(pending)


def prime(session: Session, audio: StreamAudio, cohort: int, hops: int) -> int:
    """Hops 0 .. hops - 1 unpaced, each finished at once; the hops that
    emit (from the warm-up boundary on) are captured. Returns the next hop."""
    for hop in range(hops):
        pending = session.begin(audio.blocks(cohort, hop))
        if pending is not None:
            session.capture.outputs(cohort, int(pending.chunk_index[0]), session.finish(pending))
    return hops


def closed_loop(session: Session, audio: StreamAudio, hop: int, seconds: float) -> dict:
    """Serve hops back to back for ``seconds``, one dispatched ahead. The
    window counts the hops harvested in it; the hop still in flight when it
    closes is finished after it, for the check."""
    def finish(pending):
        outputs = session.finish(pending)
        session.capture.outputs(0, int(pending.chunk_index[0]), outputs)
        return outputs

    pending = session.begin(audio.blocks(0, hop))
    hop += 1
    missing = harvested = 0
    with _span("window", session.spans):
        t0 = time.perf_counter()
        while True:
            ahead = session.begin(audio.blocks(0, hop))
            hop += 1
            outputs = finish(pending)
            harvested += 1
            missing += sum(o is None for o in outputs)
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            pending = ahead
    finish(ahead)
    return dict(window_s=now - t0, hops=harvested, missing=missing, next_hop=hop)


def _scheduler_waits(cohort_module, on: bool):
    """The scheduler's sleeps recorded as ``portbench.wait`` spans: its
    module's ``time`` replaced by one whose ``sleep`` is wrapped."""
    if not on:
        return contextlib.nullcontext()

    def sleep(dt):
        with _span("wait", True):
            time.sleep(dt)

    shim = types.SimpleNamespace(perf_counter=time.perf_counter, monotonic=time.monotonic, sleep=sleep)

    @contextlib.contextmanager
    def swap():
        saved = cohort_module.time
        cohort_module.time = shim
        try:
            yield
        finally:
            cohort_module.time = saved

    return swap()


def open_loop(scheduler, sessions: List[Session], audio: StreamAudio, hop: int, periods: int,
              spans: bool, max_inflight: int) -> dict:
    """Run the real-time schedule for ``periods`` step periods. Each hop is
    timed from when it was due (``HopTiming``)."""
    from diart_tpu_torch.parallel import cohort as cohort_module

    for j, s in enumerate(sessions):
        scheduler.sessions[j].push_begin = s.begin
        scheduler.sessions[j].push_finish_rttm = s.finish
    missing = [0]

    def on_outputs(j, p, outputs):
        missing[0] += sum(o is None for o in outputs)
        sessions[j].capture.outputs(j, hop + p - sessions[j].session.warmup_blocks + 1, outputs)

    get_blocks = lambda j, p: (audio.blocks(j, hop + p), None)
    with _scheduler_waits(cohort_module, spans), _span("window", spans):
        t0 = time.perf_counter()
        timings = scheduler.run(get_blocks, periods, pipelined=True, on_outputs=on_outputs,
                                max_inflight=max_inflight)
        t1 = time.perf_counter()
    for j in range(len(sessions)):
        for name in ("push_begin", "push_finish_rttm"):
            scheduler.sessions[j].__dict__.pop(name, None)
    return dict(window_s=t1 - t0, timings=timings, missing=missing[0], hops=len(timings))
