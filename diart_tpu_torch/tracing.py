"""Spans of the serving hop, recorded only while a recording is open or
``torch.profiler`` runs.

    from diart_tpu_torch import tracing

    with tracing.recording() as record:
        ...  # serve hops
    record.spans   # the hop's spans down to the step's phases, in the order they closed
    record.phases  # the DevicePhases of each hop run on a card

The session and the engine mark where a hop's time goes:

* ``session.dispatch``: the whole of ``MultiStreamSession.push_begin``. It
  starts the hop: a new :class:`HopKey` (the session's number in the
  recording, in the order sessions first dispatched, and its hop count
  there). Inside it, on the same thread, the step's phases:

  * ``step.segmentation``: the blocks' copy to the device, the audio ring
    and frame ring advance, the stacked frontend where on, and the
    segmentation model;
  * ``step.embedding``: the overlapped-speech weights, the trunk, the head
    and the normalization (a VAD engine has none);
  * ``step.clustering``: ``cluster_step`` and its keeps, the score ring,
    the aggregation and the new state.

* ``session.wait_card``: the harvest's wait for the hop's copies.
* ``session.assemble``: the rest of the harvest, the RTTM or annotation
  assembly and the first-chunk route.

A span holds its name, its start and end (``time.perf_counter()`` seconds,
the clock of ``HopTiming``), its thread, its hop's key, its parent (the id
of the innermost span open on the same thread) and, in a sharded engine,
its shard's index. Every span belongs to a hop: the step's phases take the
dispatch's key, the harvest's spans the pending hop's. A site outside a hop
of this recording (``warm()``, a bare ``engine.step``, a hop dispatched
before the recording opened) records nothing.

On a CUDA device the engine also records four timing events on the step's
stream: at the step's start, after the segmentation, after the embedding
and at the step's end, and a fifth where the embedding's trunk returns
(``mark_trunk``). The harvest reads the intervals once the hop's fetch
event, queued after them, has completed, so reading them adds no
synchronization (``settle``): :class:`DevicePhases`, one a shard.

The recorder also records while ``torch.profiler`` runs, with no
recording open: the hops dispatched in a profile go to a record of their
own, :func:`last_profile`. A hop dispatched with no profile running ends
that record, and the next profile's first hop starts a new one (profiles
with no such hop between them share one). So a profiled window
(``torch.profiler.profile``) holds the port's spans beside the device's
operations, with nothing to switch on.

With no recording open and no profiler running, every site costs a check
or two and returns a shared no-op (``NOOP``; ``NO_MARKS`` for the device
events): nothing is allocated, kept or timed.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

__all__ = [
    "DevicePhases",
    "HopKey",
    "NOOP",
    "NO_MARKS",
    "Record",
    "Span",
    "device_marks",
    "hop",
    "last_profile",
    "recording",
    "settle",
    "span",
]


class HopKey(NamedTuple):
    """The key every span and device phase of one hop shares."""

    session: int  # the session's number in the recording
    index: int  # its hops dispatched in the recording before this one


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter() seconds
    end: float
    thread: int  # threading.get_ident() of the thread it ran on
    hop: HopKey
    parent: Optional[int]  # id of the innermost span open on its thread
    id: int
    shard: Optional[int] = None  # the shard of a sharded engine's step


class DevicePhases(NamedTuple):
    """A hop's device milliseconds between the step's four events."""

    hop: HopKey
    shard: Optional[int]
    segmentation_ms: float  # step start -> after the segmentation
    embedding_ms: float  # -> after the embedding (0 in a VAD engine)
    clustering_ms: float  # -> the step's end
    trunk_ms: Optional[float] = None  # after the segmentation -> the trunk's return (None: no trunk event)


NOOP = contextlib.nullcontext()


class _NoMarks:
    __slots__ = ()

    def mark(self) -> None:
        pass

    def mark_trunk(self) -> None:
        pass


NO_MARKS = _NoMarks()

_record: Optional["Record"] = None  # the open recording()
_profiled: Optional["Record"] = None  # the latest profile's
_profile_live = False  # whether _profiled takes the running profile's hops
_profile_lock = threading.Lock()


def _profiling() -> bool:
    """Whether ``torch.profiler`` runs, in any thread."""
    return getattr(_torch_profiler, "_is_profiler_enabled", False)


def _current() -> Optional["Record"]:
    """The record a site writes to: the open recording, else the running
    profile's, else None."""
    record = _record
    if record is None and _profile_live and _profiling():
        record = _profiled
    return record


class Record:
    """What one recording, or one profile, holds: ``spans`` and
    ``phases``, in memory until the recording closes (a profile's: until
    a later profile starts a new one)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.phases: List[DevicePhases] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._owners: Dict[int, list] = {}  # id(session) -> [its number, hops so far]
        # the hop keys of this recording, each the very object handed out: a
        # key of an earlier recording may equal one, but is not it
        self._issued: Dict[HopKey, HopKey] = {}
        self._marks: Dict[HopKey, list] = {}  # a dispatched hop's events, until its harvest
        self._local = threading.local()

    def _stack(self) -> list:
        """The spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_hop(self, owner) -> HopKey:
        with self._lock:
            entry = self._owners.setdefault(id(owner), [len(self._owners), 0])
            key = HopKey(entry[0], entry[1])
            entry[1] += 1
            self._issued[key] = key
        return key


class _Open:
    """A span being timed; recorded when it closes, even by an exception."""

    __slots__ = ("_record", "_name", "_hop", "_shard", "_parent", "_id", "_start")

    def __init__(self, record: Record, name: str, key: HopKey, shard, parent):
        self._record, self._name, self._hop, self._shard = record, name, key, shard
        self._parent = None if parent is None else parent._id
        self._id = next(record._ids)

    def __enter__(self) -> HopKey:
        self._record._stack().append(self)
        self._start = time.perf_counter()
        return self._hop

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self._record._stack().pop()
        self._record.spans.append(Span(self._name, self._start, end, threading.get_ident(), self._hop,
                               self._parent, self._id, self._shard))
        return False


class _Marks:
    """One step's timing events on its device's current stream: the four
    phase boundaries in order, and the trunk's return apart."""

    __slots__ = ("_device", "_shard", "_events", "_trunk")

    def __init__(self, device: torch.device, shard: Optional[int]):
        self._device, self._shard, self._events, self._trunk = device, shard, [], None

    def _event(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def mark(self) -> None:
        self._events.append(self._event())

    def mark_trunk(self) -> None:
        self._trunk = self._event()

    def read(self, key: HopKey) -> DevicePhases:
        start, seg, emb, end = self._events
        trunk = None if self._trunk is None else seg.elapsed_time(self._trunk)
        return DevicePhases(key, self._shard, start.elapsed_time(seg), seg.elapsed_time(emb),
                            emb.elapsed_time(end), trunk)


def last_profile() -> Optional[Record]:
    """What the port recorded under the latest ``torch.profiler`` profile
    in which it dispatched a hop, with no recording open; None before
    any."""
    return _profiled


@contextlib.contextmanager
def recording():
    """Record the process's hops until the block ends; yields the
    :class:`Record`. One recording at a time."""
    global _record
    if _record is not None:
        raise RuntimeError("a recording is already open")
    record = Record()
    _record = record
    try:
        yield record
    finally:
        _record = None
        record._marks.clear()


def hop(name: str, owner):
    """The span that starts a new hop of ``owner`` (a session); entered, it
    gives the hop's key (None where nothing records)."""
    global _profiled, _profile_live
    record = _record
    if record is None:
        if not _profiling():
            _profile_live = False
            return NOOP
        if not _profile_live:
            with _profile_lock:  # one record however many threads dispatch
                if not _profile_live:
                    _profiled, _profile_live = Record(), True
        record = _profiled
    stack = record._stack()
    return _Open(record, name, record._new_hop(owner), None, stack[-1] if stack else None)


def span(name: str, hop: Optional[HopKey] = None, shard: Optional[int] = None):
    """A span of ``hop``, or of the hop of the innermost span open on this
    thread; the no-op where that is no hop of the open recording."""
    record = _current()
    if record is None:
        return NOOP
    stack = record._stack()
    parent = stack[-1] if stack else None
    if hop is None and parent is not None:
        hop = parent._hop
    if hop is None or record._issued.get(hop) is not hop:
        return NOOP
    return _Open(record, name, hop, shard, parent)


def device_marks(device: torch.device, shard: Optional[int] = None):
    """The step's timing events (``mark()`` at each phase boundary,
    ``mark_trunk()`` where the embedding's trunk returns): on a CUDA device
    inside a recorded hop, else ``NO_MARKS``."""
    record = _current()
    if record is None or device.type != "cuda":
        return NO_MARKS
    stack = record._stack()
    if not stack:
        return NO_MARKS
    marks = _Marks(device, shard)
    record._marks.setdefault(stack[-1]._hop, []).append(marks)
    return marks


def settle(key: Optional[HopKey]) -> None:
    """Read a harvested hop's device phases into the recording. Call it
    once the hop's fetch event has completed: its step's events, queued
    before it, have too. A hop of the latest profile is read even once the
    profile has ended."""
    record = _record if _record is not None else _profiled
    if record is None or record._issued.get(key) is not key:
        return
    for marks in record._marks.pop(key, ()):
        record.phases.append(marks.read(key))
