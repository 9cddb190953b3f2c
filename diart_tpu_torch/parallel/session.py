"""Host-side session management for the multi-stream engine (port of
``diart_tpu/parallel/session.py``).

Bridges the engine (:class:`MultiStreamEngine`) to the annotation world:
tracks per-stream warm-up (a stream emits once a full chunk accumulated),
rebuilds the first-chunk prepend, binarizes the latency-delayed scores,
applies per-stream timestamp shifts and slices the matching audio region —
per chunk, the (Annotation, waveform) pairs diart's pipelines emit, or, on
the serving routes, one RTTM text per stream.

Dispatch and harvest are split (:meth:`MultiStreamSession.push_begin` /
``push_finish*``): the dispatch queues the step, the device-side
binarize-and-pack and the device-to-host copies (``non_blocking``, into
pinned memory) and records one CUDA event a device; it never waits for the
card. The harvest waits on those events before it reads any fetched byte,
then assembles the text on the host. While a recording is open
(:mod:`..tracing`), the dispatch is the span ``session.dispatch`` that starts
a hop, and the harvest's wait and assembly are ``session.wait_card`` and
``session.assemble``.

A sharded engine (``mesh``) hands back :class:`~.engine.Sharded` outputs:
each shard is packed and fetched on its own device, and the harvest joins
the fetched pieces in stream order, so the host sees the bytes an
unsharded engine's hop gives.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flaxio, native, tracing
from ..core.annotation import Annotation
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..models.base import ZIP_MAGIC
from ..ops import _build
from ..ops.binarize import binarize, binarize_rttm, pack_binarized_bits
from .engine import MultiStreamEngine, Sharded, StreamState, to_device

__all__ = ["MultiStreamSession"]


def _from_flax(tree, path) -> dict:
    """A JAX session file's state (flax's map of the StreamState fields,
    numpy leaves) as CPU tensors."""
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a session state (a map of StreamState fields)")

    def tensor(leaf):
        if isinstance(leaf, dict):
            return {k: tensor(v) for k, v in leaf.items()}
        if isinstance(leaf, torch.Tensor):
            return leaf
        if not isinstance(leaf, np.ndarray):
            raise ValueError(f"{path}: a state leaf is a {type(leaf).__name__}, not an array")
        return torch.from_numpy(leaf)

    return {k: tensor(v) for k, v in tree.items()}


def _fit(name: str, got: torch.Tensor, want) -> torch.Tensor:
    """A checkpoint leaf checked against the leaf ``want`` of this engine's
    state. A JAX engine's phase-major window (B, s, n / s) is laid out as
    the flat (B, n) ``want`` holds (sample i at [b, i % s, i // s])."""
    if got.dim() == 3 and len(want.shape) == 2 and got.shape[0] == want.shape[0] \
            and got.shape[1] * got.shape[2] == want.shape[1]:
        got = got.transpose(1, 2).reshape(got.shape[0], -1)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(
            f"checkpoint field {name!r}: {tuple(got.shape)} {got.dtype}; "
            f"this engine needs {tuple(want.shape)} {want.dtype}"
        )
    return got


def _parts(value) -> tuple:
    """The shards of an engine output: one for an unsharded engine."""
    return tuple(value) if isinstance(value, Sharded) else (value,)


@dataclass
class _PendingHop:
    """A dispatched-but-not-harvested hop (see ``push_begin``): the host
    tensors its device-to-host copies fill (a list of pieces, one a shard,
    for each fetched array), the events that say they have landed (one a
    device), and host snapshots of everything the assembly needs, so slot
    churn between dispatch and harvest cannot corrupt it."""

    fetch: list
    events: list
    run_mask: np.ndarray
    chunk_index: np.ndarray
    first_rows: np.ndarray
    uris: List[str]
    shifts: List[float]
    # fetch[0] holds the packed device-binarized bits (binarize_on_device)
    # instead of the aggregated scores; device_aggregated keeps the scores
    # reachable for the annotation route either way
    bits: bool = False
    device_aggregated: Optional[torch.Tensor] = None
    hop: Optional[tracing.HopKey] = None  # the hop's key in an open recording


class MultiStreamSession:
    """Drives N concurrent streams and assembles per-stream outputs.

    Parameters
    ----------
    engine: the multi-stream engine.
    uris: stream identifiers (len == engine.batch_size).
    tau_active: binarization threshold.
    timestamp_shifts: per-stream shift applied to output timestamps.
    collect_audio: also return the aggregated audio region per output
        (blocks on the card are copied back to the host for it, after the
        hop's step is queued; a session without it never waits for the
        card in ``push_begin``).
    quantize_transfer: ship int16 PCM blocks to the device (half the
        host-to-device bytes; dequantized on the device, exact to 1/32768).
        Every float block is quantized: a numpy array on the host, a tensor
        on its own device.
    binarize_on_device: RTTM-route hops fetch a device-binarized packed
        bitmap (one bit per (frame, speaker) cell, 32x fewer device-to-host
        bytes) instead of f32 scores, with the same f32 comparison the host
        route makes. The annotation route (:meth:`push`) always fetches
        the scores.
    """

    def __init__(
        self,
        engine: MultiStreamEngine,
        uris: Optional[Sequence[str]] = None,
        tau_active: float = 0.6,
        timestamp_shifts: Optional[Sequence[float]] = None,
        collect_audio: bool = True,
        quantize_transfer: bool = False,
        binarize_on_device: bool = True,
    ):
        self.engine = engine
        b = engine.batch_size
        self.uris = list(uris) if uris is not None else [f"stream{i}" for i in range(b)]
        assert len(self.uris) == b
        self.tau_active = tau_active
        self.shifts = list(timestamp_shifts) if timestamp_shifts else [0.0] * b
        self.collect_audio = collect_audio
        self.quantize_transfer = quantize_transfer
        self.binarize_on_device = binarize_on_device

        self.state: StreamState = engine.init_state()
        self.blocks_seen = np.zeros(b, np.int64)
        self.warmup_blocks = int(round(engine.duration / engine.step_duration))
        # dispatched-but-unharvested hops, for the collect_audio guard of
        # push_begin; incremented on the dispatching thread and decremented
        # on a harvest thread, hence the lock
        self._inflight_lock = threading.Lock()
        self._inflight_hops = 0
        if self.collect_audio:
            self._audio = np.zeros((b, engine.chunk_samples), np.float32)

    @property
    def batch_size(self) -> int:
        return self.engine.batch_size

    def reset_slot(self, index: int, uri: Optional[str] = None, shift: float = 0.0):
        """Recycle a stream slot for a new session."""
        self.reset_slots([index], uris=None if uri is None else [uri], shifts=[shift])

    def reset_slots(
        self,
        indices: Sequence[int],
        uris: Optional[Sequence[Optional[str]]] = None,
        shifts: Optional[Sequence[float]] = None,
    ) -> None:
        """Recycle several stream slots with one ``engine.reset_streams``."""
        indices = list(indices)
        if not indices:
            return
        mask = np.zeros((self.batch_size,), bool)
        mask[np.asarray(indices, int)] = True
        self.state = self.engine.reset_streams(self.state, mask)
        for k, index in enumerate(indices):
            self.blocks_seen[index] = 0
            self.shifts[index] = shifts[k] if shifts is not None else 0.0
            if uris is not None and uris[k] is not None:
                self.uris[index] = uris[k]
            if self.collect_audio:
                self._audio[index] = 0.0

    def warm(self) -> None:
        """Build and run everything the serving loop can reach before the
        first real hop: the CUDA kernels, the native assembler, the step in
        warm-up and steady state, every fetch route and the slot reset, on a
        scratch state. The session's state and bookkeeping are untouched, so
        this is safe at any point in a server's life."""
        native.rttm_available()
        eng = self.engine
        if eng.device.type == "cuda":
            _build.build()
        b = self.batch_size
        blocks = np.zeros((b, eng.step_samples), np.int16 if self.quantize_transfer else np.float32)
        state = eng.init_state()
        present = np.ones(b, bool)
        out = None
        for k in range(self.warmup_blocks + 1):
            state, out = eng.step(state, blocks, present, present & (k + 1 >= self.warmup_blocks))
        aggs, news = _parts(out.aggregated), _parts(out.newest)
        rows = lambda t: t.index_select(0, to_device(np.arange(t.shape[0]), t.device))
        fetch = [
            list(aggs),
            [pack_binarized_bits(a, float(self.tau_active)) for a in aggs],
            [rows(n) for n in news],
            [rows(a) for a in aggs],
        ]
        _, events = self._fetch(fetch)
        for event in events:
            event.synchronize()
        eng.reset_streams(state, present)

    # ------------------------------------------------------------------ #
    # Checkpoint / resume
    # ------------------------------------------------------------------ #
    def save(self, path) -> None:
        """Persist the whole session (device state + host bookkeeping):
        ``path`` holds the state's tensors (``torch.save``, on the CPU),
        ``.json`` the bookkeeping and precision provenance, ``.audio.npy``
        the audio window."""
        path = Path(path)
        state = {
            name: ({k: v.cpu() for k, v in t.items()} if isinstance(t, dict) else t.cpu())
            for name, t in self.state._asdict().items()
        }
        torch.save(state, path)
        meta = {
            "uris": self.uris,
            "shifts": self.shifts,
            "blocks_seen": self.blocks_seen.tolist(),
            "tau_active": self.tau_active,
            # the declared numerics policy and the switches as they applied
            # on the engine's device, so a checkpoint's numerics reproduce
            "precision": self.engine.precision.as_dict(),
            "precision_resolved": self.engine.precision.resolved(self.engine.device),
        }
        if self.collect_audio:
            np.save(path.with_suffix(".audio.npy"), self._audio)
        path.with_suffix(".json").write_text(json.dumps(meta))

    def restore(self, path) -> None:
        """Resume a saved session (same engine geometry) on the engine's
        device, or its shards' (a checkpoint holds the whole stream axis,
        so it restores on a sharded or an unsharded engine alike).

        ``path`` is this class's file or the one ``diart_tpu``'s session
        writes (flax msgpack of its state, told apart by the bytes: a
        ``torch.save`` file is a zip), with the same ``.json`` bookkeeping
        and ``.audio.npy`` window. The JAX engine may hold a SincNet
        model's waveform window phase-major, ``(B, s, samples / s)`` with
        sample ``i`` at ``[b, i % s, i // s]``; it is laid out flat here.
        The meta's JAX-only precision switches are not read. A field whose
        shape or dtype this engine does not hold raises."""
        path = Path(path)
        data = path.read_bytes()
        if data[:4] == ZIP_MAGIC:
            loaded = torch.load(path, map_location="cpu", weights_only=True)
        else:
            loaded = _from_flax(flaxio.loads(data), path)
        fresh = self.engine.init_state()._asdict()
        for name, want in fresh.items():
            got = loaded.get(name)
            if got is None or isinstance(want, dict) != isinstance(got, dict) or (
                    isinstance(want, dict) and set(got) != set(want)):
                layout = lambda v: sorted(v) if isinstance(v, dict) else "an array" if v is not None else "nothing"
                raise ValueError(f"checkpoint field {name!r}: {layout(got)}; this engine needs {layout(want)}")
            if isinstance(want, dict):
                loaded[name] = {k: _fit(name, got[k], want[k]) for k in want}
            else:
                loaded[name] = _fit(name, got, want)
        self.state = self.engine.place_state(StreamState(**{name: loaded[name] for name in fresh}))
        meta = json.loads(path.with_suffix(".json").read_text())
        self.uris = list(meta["uris"])
        self.shifts = list(meta["shifts"])
        self.blocks_seen = np.asarray(meta["blocks_seen"], np.int64)
        self.tau_active = meta["tau_active"]
        audio_path = path.with_suffix(".audio.npy")
        if self.collect_audio and audio_path.exists():
            self._audio = np.load(audio_path)

    # ------------------------------------------------------------------ #
    def push(
        self, blocks, present: Optional[np.ndarray] = None
    ) -> List[Optional[Tuple[Annotation, Optional[SlidingWindowFeature]]]]:
        """Feed one step-sized block per stream; return per-stream outputs.

        blocks: (B, step_samples); present: (B,) bool mask of streams that
        actually have new audio (others are frozen this tick).

        Returns one entry per stream: ``None`` while warming up or absent,
        else ``(annotation, audio_region)``.
        """
        pending = self.push_begin(blocks, present, rttm=False)
        if pending is None:
            return [None] * self.batch_size
        return self.push_finish(pending)

    def push_begin(
        self, blocks, present: Optional[np.ndarray] = None, rttm: bool = True
    ) -> Optional[_PendingHop]:
        """Dispatch one hop without waiting for the card: advance the
        session state, queue the step, the fetched tensors' device-to-host
        copies and an event after them, and return a pending handle — or
        ``None`` when no stream produced output this hop (warm-up).

        ``push_finish(pending)`` / ``push_finish_rttm(pending)`` wait for the
        copies and assemble the outputs, so a serving loop overlaps hop k's
        fetch and assembly with hop k+1's dispatch. ``push_begin`` calls stay
        serial, and pendings are finished in dispatch order. The handle
        snapshots uris, shifts and chunk indices, so slot resets may proceed
        while a hop is in flight — but a ``collect_audio=True`` session must
        use the synchronous :meth:`push` (resets zero audio rows in place).

        rttm: the finish route this hop is destined for. True
        (``push_finish_rttm``) lets ``binarize_on_device`` fetch the packed
        bits instead of the scores; False (``push_finish``) fetches the
        scores.
        """
        with tracing.hop("session.dispatch", self) as hop:
            return self._dispatch(blocks, present, rttm, hop)

    def _dispatch(self, blocks, present, rttm: bool, hop) -> Optional[_PendingHop]:
        """``push_begin``'s work; ``hop``: its key in an open recording."""
        b = self.batch_size
        present = np.ones(b, bool) if present is None else np.asarray(present, bool)
        if self.collect_audio and self._inflight_hops:
            # the audio window advances in place below, so an unfinished
            # hop's push_finish would slice the next hop's samples
            raise RuntimeError(
                "push_begin with a hop still in flight requires "
                "collect_audio=False (the audio ring advances in place); "
                "finish the pending hop first or use the synchronous push"
            )

        self.blocks_seen[present] += 1
        run_mask = present & (self.blocks_seen >= self.warmup_blocks)

        device_blocks = self._quantize(blocks) if self.quantize_transfer else blocks
        self.state, out = self.engine.step(self.state, device_blocks, present, run_mask)
        if self.collect_audio:
            # after the step is queued: a copy of blocks on the card waits
            # for the work before it, and the step needs nothing from it
            host = blocks.detach().cpu().numpy() if isinstance(blocks, torch.Tensor) else blocks
            upd = np.concatenate([self._audio[:, self.engine.step_samples :], host], axis=1)
            self._audio = np.where(present[:, None], upd, self._audio)
        if not run_mask.any():
            return None

        # the chunk index of the chunk just emitted, on the host: a stream
        # runs once blocks_seen >= warmup, and each present hop counts
        chunk_index = self.blocks_seen - self.warmup_blocks
        # the full ``newest`` tensor is only read for the first-chunk
        # prepend, so only those streams' rows are gathered and fetched
        first_rows = np.flatnonzero(run_mask & (chunk_index == 0))
        bits = self.binarize_on_device and rttm
        aggs = _parts(out.aggregated)
        fetch = [[self._pack(a) for a in aggs] if bits else list(aggs)]
        if first_rows.size:
            newest, agg_rows = [], []
            for (lo, hi), new, agg in zip(self.engine.shard_bounds, _parts(out.newest), aggs):
                rows = first_rows[(first_rows >= lo) & (first_rows < hi)] - lo
                if rows.size:
                    idx = to_device(rows, new.device)
                    newest.append(new.index_select(0, idx))
                    if bits:
                        # the prepend needs those streams' aggregated rows too
                        agg_rows.append(agg.index_select(0, idx))
            fetch.append(newest)
            if bits:
                fetch.append(agg_rows)
        host, events = self._fetch(fetch)
        with self._inflight_lock:
            self._inflight_hops += 1
        return _PendingHop(
            fetch=host,
            events=events,
            run_mask=run_mask,
            chunk_index=chunk_index.copy(),
            first_rows=first_rows,
            uris=list(self.uris),
            shifts=list(self.shifts),
            bits=bits,
            device_aggregated=out.aggregated,
            hop=hop,
        )

    @staticmethod
    def _quantize(blocks):
        """Float blocks as int16 PCM (clamp, then truncate toward zero, as
        numpy's ``astype`` does): a numpy array on the host, a tensor on its
        own device; integer blocks as they are."""
        if isinstance(blocks, torch.Tensor):
            if not blocks.dtype.is_floating_point:
                return blocks
            return torch.clamp(blocks * 32768.0, -32768, 32767).to(torch.int16)
        blocks = np.asarray(blocks)
        if np.issubdtype(blocks.dtype, np.integer):
            return blocks
        return np.clip(blocks * 32768.0, -32768, 32767).astype(np.int16)

    @staticmethod
    def _fetch(groups) -> Tuple[list, list]:
        """Queue device-to-host copies of ``groups`` (lists of pieces, into
        pinned memory, no host wait) and one event after them on each
        device; on the CPU, the tensors as they are and no event. Read the
        host tensors only after the events have completed: before them they
        hold stale bytes."""
        if not groups[0][0].is_cuda:
            return [list(g) for g in groups], []
        host = [[t.to("cpu", non_blocking=True) for t in g] for g in groups]
        devices = list(dict.fromkeys(t.device for g in groups for t in g))
        events = []
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append(event)
        return host, events

    def _pack(self, aggregated: torch.Tensor) -> torch.Tensor:
        """This hop's aggregated scores thresholded and bit-packed on their
        device (``ops.binarize.pack_binarized_bits``)."""
        return pack_binarized_bits(aggregated, float(self.tau_active))

    def _harvest(self, pending: _PendingHop):
        """Wait for a pending hop's copies and return ``(main, newest_rows,
        agg_rows)``: ``main`` is the aggregated scores, or the packed bits
        in ``binarize_on_device`` mode (where ``agg_rows`` carries the
        aggregated rows of first-chunk streams)."""
        with tracing.span("session.wait_card", hop=pending.hop):
            for event in pending.events:
                event.synchronize()
        tracing.settle(pending.hop)
        fetch = [g[0].numpy() if len(g) == 1 else np.concatenate([t.numpy() for t in g])
                 for g in pending.fetch]
        main = fetch[0]
        newest_rows, agg_rows = {}, {}
        if pending.first_rows.size:
            newest_rows = {int(r): fetch[1][k] for k, r in enumerate(pending.first_rows)}
            if pending.bits:
                agg_rows = {int(r): fetch[2][k] for k, r in enumerate(pending.first_rows)}
        with self._inflight_lock:
            self._inflight_hops = max(0, self._inflight_hops - 1)
        return main, newest_rows, agg_rows

    def push_finish(
        self, pending: _PendingHop
    ) -> List[Optional[Tuple[Annotation, Optional[SlidingWindowFeature]]]]:
        """Wait for a pending hop's copies and assemble its annotations."""
        aggregated, newest_rows, _ = self._harvest(pending)
        with tracing.span("session.assemble", hop=pending.hop):
            return self._annotations(pending, aggregated, newest_rows)

    def _annotations(self, pending: _PendingHop, aggregated, newest_rows):
        """``push_finish``'s assembly of a harvested hop."""
        run_mask = pending.run_mask
        chunk_index = pending.chunk_index
        if pending.bits:
            # the annotation route needs the scores, which a bits hop did not
            # fetch: fetch them now (serving loops take the RTTM routes)
            aggregated = pending.device_aggregated.cpu().numpy()

        geometry = self.engine.geometry
        eng = self.engine
        outputs: List[Optional[Tuple[Annotation, Optional[SlidingWindowFeature]]]] = []
        for i in range(self.batch_size):
            if not run_mask[i]:
                outputs.append(None)
                continue
            c = int(chunk_index[i])
            shift = pending.shifts[i]
            if c == 0:
                # first-chunk prepend: cover [0, duration - latency + step]
                first = newest_rows[i][geometry.first_indices].copy()
                first[-geometry.num_out :] = aggregated[i]
                res = geometry.first_resolution
                window = SlidingWindow(start=shift, duration=res, step=res)
                scores = SlidingWindowFeature(first, window)
                region_start, region_len = 0.0, first.shape[0] * res
            else:
                res = geometry.out_resolution
                start = eng.output_start(c)
                window = SlidingWindow(start=start + shift, duration=res, step=res)
                scores = SlidingWindowFeature(aggregated[i], window)
                region_start = start - c * eng.step_duration  # offset in the window
                region_len = eng.step_duration

            annotation = binarize(scores, self.tau_active, uri=pending.uris[i])

            audio = None
            if self.collect_audio:
                sr = eng.sample_rate
                lo = int(round(region_start * sr))
                hi = min(lo + int(round(region_len * sr)), eng.chunk_samples)
                audio = SlidingWindowFeature(
                    self._audio[i, lo:hi, None],
                    SlidingWindow(
                        start=(0.0 if c == 0 else eng.output_start(c)) + shift,
                        duration=1.0 / sr,
                        step=1.0 / sr,
                    ),
                )
            outputs.append((annotation, audio))
        return outputs

    def push_rttm(self, blocks, present: Optional[np.ndarray] = None) -> List[Optional[str]]:
        """``push`` for the serving wire: one RTTM text per stream (``None``
        while warming up or absent) instead of ``(Annotation, audio)``."""
        pending = self.push_begin(blocks, present)
        if pending is None:
            return [None] * self.batch_size
        return self.push_finish_rttm(pending)

    def push_finish_rttm(self, pending: _PendingHop) -> List[Optional[str]]:
        """``push_finish`` that emits per-stream RTTM text directly: the
        steady-state streams through the native assembler in one call (on
        the packed bits or the scores), the first-chunk streams through the
        per-stream route (their prepended window has its own length and
        resolution). String-identical to ``push_finish(...)[i][0].to_rttm()``."""
        main, newest_rows, agg_rows = self._harvest(pending)
        with tracing.span("session.assemble", hop=pending.hop):
            return self._texts(pending, main, newest_rows, agg_rows)

    def _texts(self, pending: _PendingHop, main, newest_rows, agg_rows) -> List[Optional[str]]:
        """``push_finish_rttm``'s assembly of a harvested hop."""
        b = self.batch_size
        run_mask = pending.run_mask
        chunk_index = pending.chunk_index
        geometry = self.engine.geometry
        eng = self.engine
        outputs: List[Optional[str]] = [None] * b

        steady_mask = run_mask & (chunk_index > 0)
        if steady_mask.any():
            # per-stream window starts, in output_start's float operation
            # order (((c * step) + duration) - latency) + shift, so the %.3f
            # renderings equal the per-stream route's
            starts = (
                chunk_index * eng.step_duration
                + eng.duration
                - eng.latency
                + np.asarray(pending.shifts)
            )
            if pending.bits:
                speakers = int(pending.device_aggregated.shape[-1])
                texts = native.rttm_from_bits(
                    main, geometry.num_out, speakers, starts, geometry.out_resolution,
                    pending.uris, emit=steady_mask,
                )
            else:
                texts = native.rttm_from_scores(
                    main, starts, geometry.out_resolution, self.tau_active, pending.uris,
                    emit=steady_mask,
                )
            for i in np.flatnonzero(steady_mask):
                outputs[i] = texts[i]

        for i in range(b):
            if not run_mask[i] or int(chunk_index[i]) != 0:
                continue
            first = newest_rows[i][geometry.first_indices].copy()
            first[-geometry.num_out :] = agg_rows[i] if pending.bits else main[i]
            res0 = geometry.first_resolution
            window = SlidingWindow(start=pending.shifts[i], duration=res0, step=res0)
            outputs[i] = binarize_rttm(
                SlidingWindowFeature(first, window), self.tau_active, uri=pending.uris[i]
            )
        return outputs
