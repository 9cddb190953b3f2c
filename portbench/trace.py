"""What a traced run reads from ``torch.profiler``: the device's operations
(kernels, copies, fills) on the card's timeline, the harness's spans on the
host's, the device's busy time as the union of its operations' intervals,
and its idle gaps labelled by the span the host was in.

The profiler records the device only (CUPTI's kernel, copy and fill
records): recording every host-side operation as well doubled the host's
cost of a hop, which pushed the open-loop cell past its capacity. The
harness times its own spans on the host clock (``drive.SPANS``), and one
marker operation, launched on an idle card as the profile starts, puts the
two clocks on one axis.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

Interval = Tuple[str, float, float]  # (name, start us, end us)


class Profile:
    """A device-only ``torch.profiler`` session and the host time of its
    marker (``mark``, ``time.perf_counter`` seconds)."""

    def __init__(self, prof, mark: float):
        self.prof, self.mark = prof, mark


@contextlib.contextmanager
def profiled(on: bool, device="cuda"):
    """A device-only profile when ``on``: the card is idle when it starts,
    and its first operation is the marker, launched at ``mark``."""
    if not on:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else \
        [torch.profiler.ProfilerActivity.CPU]
    marker = torch.zeros(1, device=device)
    if marker.is_cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        mark = time.perf_counter()
        marker.add_(1.0)
        yield Profile(prof, mark)


def events(profile: Profile, host_spans) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, harness spans), each (name, start us, end us) on
    the profiler's clock; a host span (name, start s, end s) is moved there
    by the marker: the device's first operation started at ``mark``."""
    device = sorted((e.name, float(e.time_range.start), float(e.time_range.end)) for e in profile.prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    device.sort(key=lambda d: d[1])
    origin = device[0][1] if device else 0.0
    to_us = lambda t: origin + (t - profile.mark) * 1e6
    spans = [(name, to_us(s), to_us(e)) for name, s, e in host_spans]
    return device[1:], spans


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def window_of(spans: List[Interval]) -> Optional[Tuple[float, float]]:
    found = [(s, e) for name, s, e in spans if name == "window"]
    return found[0] if found else None


def busy_and_gaps(device: List[Interval], spans: List[Interval], window: Tuple[float, float]):
    """(busy us in the window, idle gaps [(label, us)]): a gap is labelled by
    the innermost harness span (other than the window) that holds its start,
    or ``host`` where none does."""
    lo, hi = window
    busy = clip(union([(s, e) for _, s, e in device]), lo, hi)
    total = sum(e - s for s, e in busy)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    inner = sorted((s, e, name) for name, s, e in spans if name != "window")
    starts = [s for s, _, _ in inner]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # the spans that started last before the gap (spans barely nest)
        held = [(e - s, name) for s, e, name in inner[max(0, bisect.bisect_right(starts, a) - 64):
                                                      bisect.bisect_right(starts, a)] if a < e]
        gaps.append((min(held)[1] if held else "host", b - a))
    return total, gaps


def breakdown(device: List[Interval], gaps, window: Tuple[float, float], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what
    the host was doing, each in seconds, at most ``top`` entries."""
    lo, hi = window
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        for a, b in clip([(s, e)], lo, hi):
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    idle: Dict[str, float] = {}
    for label, us in gaps:
        idle[label] = idle.get(label, 0.0) + us
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], us * 1e-6] for name, us in ops],
            "idle_gaps": [[label, us * 1e-6] for label, us in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def device_summary(device: List[Interval], window: Tuple[float, float], hops: int, top: int = 12) -> dict:
    """Device ms a hop by name, launches a hop (kernels, copies, fills) and
    the top items (pattern of ``chip_smoke.py`` ``device_summary``, :1132
    at 50f33b4, over the window's operations)."""
    lo, hi = window
    items: Dict[str, List[float]] = {}
    for name, s, e in device:
        if lo <= s < hi:
            entry = items.setdefault(name, [0.0, 0])
            entry[0] += (e - s) / 1e3
            entry[1] += 1
    ranked = sorted(items.items(), key=lambda kv: -kv[1][0])
    return dict(launches_per_hop=sum(n for _, n in items.values()) / hops,
                top_device_items=[dict(ms_per_hop=ms / hops, per_hop=n / hops, name=k[:90])
                                  for k, (ms, n) in ranked[:top]])
