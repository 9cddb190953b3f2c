"""The end-to-end metrics on synthetic timelines: a stall of the card must
move ``streams_per_card`` and the reply's tail, a slower step the reply's
median."""

import types

from portbench import e2e
from portbench.run import metric_reader
from diart_tpu_torch.parallel.cohort import HopTiming

STEP = 0.5


def closed_timeline(hop_s, seconds, stall_at=None, stall_s=0.0):
    """Harvest times of back-to-back hops; one hop stalls for ``stall_s``."""
    t, done = 0.0, []
    while True:
        t += hop_s + (stall_s if stall_at is not None and len(done) == stall_at else 0.0)
        if t > seconds:
            return done
        done.append(t)


def open_timeline(cohorts, periods, hop_s, stall_at=None, stall_s=0.0):
    """A cohort scheduler's hops on one card: each runs ``hop_s`` once due
    and the card is free; one stalls the card for ``stall_s`` more."""
    free, out = 0.0, []
    for p in range(periods):
        for j in range(cohorts):
            due = p * STEP + j * STEP / cohorts
            start = max(due, free)
            free = start + hop_s + (stall_s if (p, j) == stall_at else 0.0)
            out.append(HopTiming(j, p, due, due, free))
    return out


def test_stall_moves_streams_per_card():
    calm = closed_timeline(0.04, 30.0)
    stalled = closed_timeline(0.04, 30.0, stall_at=100, stall_s=2.0)
    a = e2e.streams_per_card(256, STEP, len(calm), 30.0)
    b = e2e.streams_per_card(256, STEP, len(stalled), 30.0)
    assert a == 256 * STEP * 750 / 30.0
    assert b < a * 0.95


def test_stall_moves_reply_p95():
    calm = open_timeline(16, 60, 0.02)
    stalled = open_timeline(16, 60, 0.02, stall_at=(30, 3), stall_s=1.5)
    assert abs(e2e.reply_p95_ms(calm) - 20.0) < 1e-6
    assert e2e.reply_p95_ms(stalled) > 5 * e2e.reply_p95_ms(calm)
    assert e2e.late_hops(calm, STEP) == 0 and e2e.late_hops(stalled, STEP) > 0


def test_slower_step_moves_reply_p50():
    calm = open_timeline(16, 60, 0.02)
    slower = open_timeline(16, 60, 0.024)
    stalled = open_timeline(16, 60, 0.02, stall_at=(30, 3), stall_s=1.5)
    assert abs(e2e.reply_p50_ms(calm) - 20.0) < 1e-6
    assert abs(e2e.reply_p50_ms(slower) - 24.0) < 1e-6
    # one stall delays the hops queued behind it, fewer than half of them
    assert abs(e2e.reply_p50_ms(stalled) - 20.0) < 1e-6


def test_reply_tail_reader():
    read = metric_reader("reply_p95_ms.realtime")
    calm = open_timeline(16, 60, 0.02)
    stalled = open_timeline(16, 60, 0.02, stall_at=(30, 3), stall_s=1.5)
    assert read(types.SimpleNamespace(timings=stalled)) == e2e.reply_p95_ms(stalled)
    assert read(types.SimpleNamespace(timings=stalled)) > 5 * read(types.SimpleNamespace(timings=calm))
    assert read(types.SimpleNamespace(timings=[])) is None
