"""The reply's tail in the traced window: the 95th percentile, over every hop
of every cohort, of ``done - due`` (``HopTiming``), in milliseconds. The hops
past it are those queued behind a stall of the host or of the card."""

from portbench import e2e


def read(r):
    return e2e.reply_p95_ms(r.timings) if r.timings else None
