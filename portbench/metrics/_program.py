"""Shared arithmetic of the readers of the program's own spans and device
phases (a helper, not a metric). The port records them while
``torch.profiler`` runs (``diart_tpu_torch.tracing.last_profile``), so a
traced window holds them; each span is put on the profiler's axis by the
mapping ``trace.events`` gave the harness's own spans, read off the window
span (``drive.SPANS``'s host seconds against ``r.window``'s us): the one
marker. Where the port records none, as a tree without the recorder, each
reader returns None."""

import statistics
import sys

from portbench import drive
from portbench.trace import clip, union, window_of


def program(r):
    """(spans on the profiler's axis, us; device phases) of the traced
    window's profile, or None where the port recorded nothing."""
    tracing = sys.modules.get("diart_tpu_torch.tracing")
    last = getattr(tracing, "last_profile", None)
    record = last() if last is not None else None
    host = window_of(drive.SPANS)
    if record is None or host is None or r.window is None:
        return None
    lo = r.window[0]
    to_us = lambda t: lo + (t - host[0]) * 1e6
    return [s._replace(start=to_us(s.start), end=to_us(s.end)) for s in list(record.spans)], list(record.phases)


def window_hops(r, spans) -> set:
    """The keys of the hops whose dispatch started inside the window."""
    lo, hi = r.window
    return {s.hop for s in spans if s.name == "session.dispatch" and lo <= s.start < hi}


def host_ms(r, name: str):
    """The median host ms of the spans named ``name`` of the window's hops."""
    got = program(r)
    if got is None:
        return None
    spans = got[0]
    hops = window_hops(r, spans)
    ms = [(s.end - s.start) * 1e-3 for s in spans if s.name == name and s.hop in hops]
    return statistics.median(ms) if ms else None


def device_ms(r, phase: str):
    """The median device ms of one phase of the window's hops' steps
    (``segmentation_ms``, ``embedding_ms`` or ``clustering_ms``)."""
    got = program(r)
    if got is None:
        return None
    spans, phases = got
    hops = window_hops(r, spans)
    ms = [getattr(p, phase) for p in phases if p.hop in hops]
    return statistics.median(ms) if ms else None


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(r, name: str):
    """The share of the window, in percent, in which the device ran no
    operation while a span named ``name`` was open, on whatever thread."""
    got = program(r)
    if got is None:
        return None
    lo, hi = r.window
    held = union(clip([(s.start, s.end) for s in got[0] if s.name == name], lo, hi))
    if not held:
        return None
    busy = union(clip([(s, e) for _, s, e in r.device], lo, hi))
    return 100.0 * (sum(e - s for s, e in held) - _overlap(held, busy)) / (hi - lo)
