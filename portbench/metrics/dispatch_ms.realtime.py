"""Host milliseconds of a hop's dispatch (``MultiStreamSession.push_begin``,
which queues the step and its copies and returns without waiting for the
card), the median over the traced window's hops."""

import statistics


def read(r):
    return statistics.median(r.dispatch_ms) if r.dispatch_ms else None
