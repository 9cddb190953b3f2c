"""Cohort scheduling: K sessions time-multiplex one card (port of
``diart_tpu/parallel/cohort.py``).

One engine hop costs a small slice of the step period, so a single
:class:`~diart_tpu_torch.parallel.session.MultiStreamSession` leaves the
card idle between hops. A :class:`CohortScheduler` runs K sessions — each
with its own device state, all sharing the ONE engine (its parameters and
kernels) — ticking cohort ``j`` at wall-clock phase ``j * step / K`` within
each step period. Capacity is ``K * engine.batch_size`` concurrent
real-time streams per card.

Two harvest modes:

* blocked (``pipelined=False``): each hop runs to completion (step, fetch
  and RTTM assembly) before the next cohort's hop; sustained iff
  ``K * hop_wall < step``.
* pipelined (``pipelined=True``, default): the scheduler thread only
  DISPATCHES hops (``push_begin``, which queues the step and its copies
  without waiting for the card); each cohort's harvest
  (``push_finish_rttm``) runs on that cohort's own single-thread executor,
  so the harvests of different cohorts overlap each other and the card's
  back-to-back steps. The harvest threads only wait on events and run the
  host assembly (the native assembler releases the GIL); the scheduler
  thread is the only one that queues work on the card, all of it on the
  default stream. Safe across cohorts because sessions share no host
  state, and per-session harvest order is kept by the per-cohort executor.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional

from .engine import MultiStreamEngine
from .session import MultiStreamSession

__all__ = ["CohortScheduler", "HopTiming"]


class HopTiming(NamedTuple):
    """Wall-clock record of one scheduled hop."""

    cohort: int
    period: int
    due: float  # scheduled dispatch time
    dispatched: float  # actual dispatch time (lateness = dispatched - due)
    done: float  # outputs ready (reply latency = done - due)


class CohortScheduler:
    """Drive K sessions at staggered phases in real time.

    Parameters
    ----------
    engine: the multi-stream engine (shared by every cohort).
    cohorts: number of sessions to time-multiplex.
    tau_active / quantize_transfer / binarize_on_device: forwarded to each
        session (the last is the 32x-smaller device-binarized fetch).
    """

    def __init__(
        self,
        engine: MultiStreamEngine,
        cohorts: int,
        tau_active: float = 0.6,
        quantize_transfer: bool = False,
        binarize_on_device: bool = True,
    ):
        assert cohorts >= 1
        self.engine = engine
        self.cohorts = cohorts
        b = engine.batch_size
        self.sessions: List[MultiStreamSession] = [
            MultiStreamSession(
                engine,
                uris=[f"c{j}s{i}" for i in range(b)],
                tau_active=tau_active,
                collect_audio=False,
                quantize_transfer=quantize_transfer,
                binarize_on_device=binarize_on_device,
            )
            for j in range(cohorts)
        ]

    @property
    def capacity(self) -> int:
        """Concurrent streams this scheduler serves in real time."""
        return self.cohorts * self.engine.batch_size

    @property
    def phase(self) -> float:
        """Wall-clock offset between consecutive cohorts' hops."""
        return self.engine.step_duration / self.cohorts

    def warm(self) -> None:
        """Build and run every serving route once (shared by all cohorts)."""
        self.sessions[0].warm()

    def prime(self, get_blocks: Callable) -> None:
        """Advance every session past its warm-up boundary (as fast as the
        device allows, no wall-clock pacing), so a subsequent :meth:`run`
        measures steady-state full-path hops. ``get_blocks(cohort, hop)``
        -> ``(blocks, present)``."""
        for j, session in enumerate(self.sessions):
            for k in range(session.warmup_blocks):
                blocks, present = get_blocks(j, k)
                session.push_rttm(blocks, present)

    def run(
        self,
        get_blocks: Callable,
        periods: int,
        pipelined: bool = True,
        on_outputs: Optional[Callable] = None,
        before_period: Optional[Callable] = None,
        start_delay: float = 0.05,
        max_inflight: int = 4,
    ) -> List[HopTiming]:
        """Run the staggered wall-clock schedule for ``periods`` step
        periods and return one :class:`HopTiming` per completed hop.

        get_blocks(cohort, period) -> (blocks, present): the audio to feed
            that cohort's hop (host arrays or tensors staged on the device).
        on_outputs(cohort, period, outputs): optional consumer of each
            hop's per-stream RTTM list (called on the harvest thread in
            pipelined mode).
        before_period(period): optional host-side hook at each period
            boundary (e.g. churn-batch ``reset_slots`` on a session).
        max_inflight: pipelined-mode backpressure — a cohort may have at
            most this many dispatched-but-unharvested hops (each holds its
            pinned fetch buffers); past it the scheduler BLOCKS on the
            cohort's oldest harvest, which shows up as dispatch lateness
            in the timings instead of unbounded memory growth. A
            sustained run never touches the bound (steady-state in-flight
            is ~1); it exists so a long overload degrades visibly rather
            than OOMing.
        """
        step = self.engine.step_duration
        phase = self.phase
        timings: List[HopTiming] = []
        executors = [
            ThreadPoolExecutor(1, f"cohort-harvest-{j}")
            for j in range(self.cohorts)
        ]
        futures = []  # (cohort, period, due, dispatched, Future -> done)
        inflight = [deque() for _ in range(self.cohorts)]

        def _harvest(j, p, pending):
            outputs = self.sessions[j].push_finish_rttm(pending)
            done = time.perf_counter()
            if on_outputs is not None:
                on_outputs(j, p, outputs)
            return done

        try:
            t0 = time.perf_counter() + start_delay
            for p in range(periods):
                if before_period is not None:
                    before_period(p)
                for j in range(self.cohorts):
                    due = t0 + p * step + j * phase
                    while True:
                        dt = due - time.perf_counter()
                        if dt <= 0:
                            break
                        time.sleep(min(dt, 0.02))
                    if pipelined:
                        while inflight[j] and inflight[j][0].done():
                            inflight[j].popleft()
                        while len(inflight[j]) >= max_inflight:
                            inflight[j].popleft().result()
                    dispatched = time.perf_counter()
                    blocks, present = get_blocks(j, p)
                    if pipelined:
                        pending = self.sessions[j].push_begin(blocks, present)
                        if pending is not None:
                            fut = executors[j].submit(_harvest, j, p, pending)
                            futures.append((j, p, due, dispatched, fut))
                            inflight[j].append(fut)
                    else:
                        outputs = self.sessions[j].push_rttm(blocks, present)
                        done = time.perf_counter()
                        if all(o is None for o in outputs):
                            # warm-up hop (no stream emitted): pipelined
                            # mode skips these (push_begin returns None),
                            # so skip here too — both modes' timing lists
                            # then cover the same hop population
                            continue
                        if on_outputs is not None:
                            on_outputs(j, p, outputs)
                        timings.append(
                            HopTiming(j, p, due, dispatched, done)
                        )
            for j, p, due, dispatched, fut in futures:
                timings.append(HopTiming(j, p, due, dispatched, fut.result()))
        finally:
            for ex in executors:
                ex.shutdown(wait=True)
        timings.sort(key=lambda t: (t.period, t.cohort))
        return timings
