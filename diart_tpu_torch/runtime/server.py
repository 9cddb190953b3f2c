"""Multiplexed streaming diarization server (port of
``diart_tpu/runtime/server.py``).

Upgrade over diart's websocket serving (its ``sources.py:204-271`` +
``console/serve.py``), which supports exactly ONE client per server
process. Here many clients multiplex into the stream-batch dimension of one
fused :class:`diart_tpu_torch.parallel.MultiStreamEngine`: each connection
claims a stream slot, its audio blocks are queued on the host, and a device
tick advances every active stream at once.

Threads: hops are dispatched and harvested on ``ThreadPoolExecutor``
threads, so the card's work is queued from those threads. The engine holds
the precision policy it was built under (a ``use(...)`` scope of the caller
does not reach them; the serve CLI installs ``--precision`` with
``precision.set_default`` before it builds the engine), kernels launch on
the calling thread's current stream, and the step's pinned staging buffers
are made per call.

Wire protocol (compatible with the reference's client, ``utils.py:56-66``):
clients send base64-encoded float32 blocks as text frames; the server sends
back the RTTM lines of each latency-delayed prediction. Extension: a client
may first send the JSON handshake ``{"format": "int16"}`` and then int16
PCM frames — half the wire bytes. ``websockets`` is imported only by
:meth:`StreamingServer.serve`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, Optional

import numpy as np

from .. import utils
from ..parallel.engine import MultiStreamEngine
from ..parallel.session import MultiStreamSession

__all__ = ["StreamingServer"]

logger = logging.getLogger(__name__)


class _ClientSlot:
    def __init__(self, index: int, websocket, dtype=np.float32):
        self.index = index
        self.websocket = websocket
        self.buffer = np.zeros((0,), dtype)
        self.wire_format = "f32"  # set by the optional JSON handshake
        self.audio_seen = False  # handshake must precede any audio
        self.closed = False


class StreamingServer:
    """Serve a fused multi-stream engine over websockets.

    Parameters
    ----------
    engine: the engine; ``engine.batch_size * cohorts`` is the max number
        of concurrent clients.
    cohorts: number of independent stream cohorts time-multiplexed onto
        the one device. Each cohort is its own
        :class:`~diart_tpu_torch.parallel.session.MultiStreamSession` (own
        device state) sharing the ONE engine (its weights and built kernels
        are per-engine, so extra cohorts cost no build and no parameter
        memory). A hop advances one cohort; in realtime mode cohort ``j``
        ticks at phase ``j * step / cohorts`` within the step period, so a
        device that is idle most of each period serves ``cohorts *
        batch_size`` concurrent streams.
    tau_active: binarization threshold for emitted predictions.
    host/port: bind address.
    realtime: if True, ticks every ``engine.step_duration`` seconds of wall
        clock; if False, ticks as fast as audio arrives (useful for tests
        and batch-over-websocket workloads).
    quantize_transfer: ship int16 PCM blocks to the device (half the
        host->device bytes per hop; dequantized on device).
    pipelined: overlap hop k's device->host fetch + RTTM assembly with hop
        k+1's dispatch (see ``_tick``). Default OFF: the overlap only pays
        where the two halves really run concurrently (several host cores)
        or under overload; on a host where dispatch and harvest contend for
        one core it only queues. Togglable per tick.
    coalesce: fast-poll wave coalescing (seconds). When > 0, a tick that
        finds only SOME active slots ready holds the hop until every
        active slot has a block queued, capped at this age — collapsing a
        synchronized client wave into one dispatched hop instead of several
        partial ones, each of which ships the full (B, step) host->device
        transfer (the device batch is always B wide). Default 0 (dispatch
        immediately): the hold taxes early senders; raise it only when the
        host->device transfer is the measured bottleneck. Overload (any
        client >= 2 blocks queued) always dispatches immediately.
    """

    def __init__(
        self,
        engine: MultiStreamEngine,
        tau_active: float = 0.6,
        host: str = "127.0.0.1",
        port: int = 7007,
        realtime: bool = False,
        quantize_transfer: bool = False,
        pipelined: bool = False,
        coalesce: float = 0.0,
        cohorts: int = 1,
        binarize_on_device: bool = True,
    ):
        self.engine = engine
        self.host = host
        self.port = port
        self.realtime = realtime
        self.pipelined = pipelined
        self.coalesce = coalesce
        self.cohorts = int(cohorts)
        assert self.cohorts >= 1
        self.sessions = [
            MultiStreamSession(
                engine,
                tau_active=tau_active,
                collect_audio=False,
                quantize_transfer=quantize_transfer,
                binarize_on_device=binarize_on_device,
            )
            for _ in range(self.cohorts)
        ]
        # single-cohort alias (tests and simple callers)
        self.session = self.sessions[0]
        # The dtype slot buffers and hop blocks are kept in. With
        # quantize_transfer everything is int16 end to end — int16-wire
        # clients' bytes are never converted on the host, f32-wire clients
        # are quantized once at ingest (same clip-scale the session would
        # apply per hop) — and the session ships the int16 block to the
        # device as-is. Without it, int16-wire clients are dequantized at
        # ingest and the pipeline stays float32.
        self._ingest_dtype = np.int16 if quantize_transfer else np.float32
        # Global slot table: slot i belongs to cohort i // batch_size,
        # lane i % batch_size of that cohort's session.
        self.slots: Dict[int, Optional[_ClientSlot]] = {
            i: None for i in range(engine.batch_size * self.cohorts)
        }
        # Slots claimed since the last tick, per cohort. Session state is
        # only touched from _tick (resets first, then the push), so a
        # reset can't race the step's state update on the executor thread
        # or be lost to its state reassignment.
        self._pending_resets: list = [set() for _ in range(self.cohorts)]
        self._stop = None
        self._loop = None
        # pipelined serving (see _tick): a single-thread dispatch pool
        # keeps push_begin calls serial (state threading), and ONE
        # single-thread harvest pool PER COHORT keeps each session's
        # push_finish calls in dispatch order while letting different
        # cohorts' harvests (each a device->host round trip) overlap, as
        # parallel/cohort.py schedules them (one shared harvest thread
        # would serialize all cohorts' round trips)
        from concurrent.futures import ThreadPoolExecutor

        self._dispatch_pool = ThreadPoolExecutor(1, "diart-dispatch")
        self._harvest_pools = [
            ThreadPoolExecutor(1, f"diart-harvest-{j}")
            for j in range(self.cohorts)
        ]
        self._outbox: Optional[asyncio.Queue] = None
        self._in_flight = 0  # dispatched hops whose replies haven't gone out
        # first-ready time of each cohort's current wave, _tick
        self._wave_t0: list = [None] * self.cohorts
        # ingest high-water mark per client (4 chunk windows = 20 s at
        # the default geometry): past this the handler pauses reading
        # (websocket/TCP backpressure) until the ticker drains the slot,
        # see _handler
        self._max_buffer_samples = 4 * engine.chunk_samples

    # ------------------------------------------------------------------ #
    def _claim_slot(self, websocket) -> Optional[_ClientSlot]:
        for i, slot in self.slots.items():
            if slot is None:
                client = _ClientSlot(i, websocket, self._ingest_dtype)
                self.slots[i] = client
                self._pending_resets[i // self.engine.batch_size].add(i)
                return client
        return None

    def _release_slot(self, client: _ClientSlot):
        client.closed = True
        self.slots[client.index] = None

    async def _handler(self, websocket):
        client = self._claim_slot(websocket)
        if client is None:
            await websocket.close(code=1013, reason="server full")
            return
        logger.info("client connected on slot %d", client.index)
        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    # the wire protocol is text frames (base64 audio /
                    # JSON handshake); a binary frame
                    # would be mis-parsed, so reject it explicitly
                    # instead of letting startswith raise into the
                    # catch-all below
                    await websocket.close(
                        code=1003, reason="binary frames unsupported"
                    )
                    return
                if message.startswith("{"):
                    # Optional wire-config handshake before any audio,
                    # e.g. {"format": "int16"} (half the wire bytes of the
                    # reference's float32 protocol). Reference clients
                    # never send JSON — base64 audio cannot start with
                    # '{' — so the default f32 path is untouched.
                    if client.audio_seen:
                        # the wire contract is handshake-BEFORE-audio; a
                        # mid-stream
                        # format switch would silently reinterpret queued
                        # bytes, so reject it as a protocol error
                        await websocket.close(
                            code=1002, reason="handshake after audio"
                        )
                        return
                    fmt = json.loads(message).get("format", "f32")
                    if fmt not in ("f32", "int16"):
                        await websocket.close(
                            code=1003, reason=f"unknown format {fmt!r}"
                        )
                        return
                    client.wire_format = fmt
                    continue
                samples = self._ingest(message, client.wire_format)
                client.audio_seen = True
                client.buffer = np.concatenate([client.buffer, samples])
                while (
                    client.buffer.shape[0] > self._max_buffer_samples
                    and self.slots.get(client.index) is client
                ):
                    # Backpressure, not eviction: a client streaming
                    # faster than real time (the file-streaming CLI
                    # client is one) is legitimate — pause reading until
                    # the ticker drains the slot, and TCP flow control
                    # throttles the sender. This bounds both host memory
                    # and the per-message concatenate cost without
                    # breaking fast senders; per-message size is bounded
                    # separately by the websocket max frame size.
                    await asyncio.sleep(0.01)
        except Exception as e:  # connection errors end the stream
            logger.info("client %d disconnected: %s", client.index, e)
        finally:
            self._release_slot(client)

    def _ingest(self, message: str, wire_format: str) -> np.ndarray:
        """Decode one audio message into the server's ingest dtype.
        int16 wire + int16 ingest (quantize_transfer) is the zero-copy
        path: the PCM bytes go to the device untouched. The f32->int16
        quantization here is the exact clip-scale ``session.push_begin``
        applies, so WHERE the quantization happens never changes the
        output (pinned by tests/test_torch_server.py wire-format parity)."""
        if wire_format == "int16":
            samples = utils.decode_audio_int16(message)[0]
            if self._ingest_dtype == np.int16:
                return samples
            return samples.astype(np.float32) / 32768.0
        samples = utils.decode_audio(message)[0]
        if self._ingest_dtype == np.int16:
            return np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
        return samples

    async def _tick(self, cohort: int = 0):
        """Advance every stream in ``cohort`` that has a full step block
        queued. One hop advances one cohort; the ticker staggers cohorts
        across the step period (realtime) or round-robins them (fast
        poll), so cohorts time-multiplex the device."""
        session = self.sessions[cohort]
        b = self.engine.batch_size
        lo = cohort * b  # this cohort's slot range is [lo, lo + b)
        if self._pending_resets[cohort]:
            idxs = [
                i
                for i in self._pending_resets[cohort]
                if self.slots[i] is not None
            ]
            self._pending_resets[cohort].clear()
            if idxs:
                # one reset for the whole churn batch (a per-index reset
                # would serialize client admission on the device)
                session.reset_slots(
                    [i - lo for i in idxs], uris=[f"client{i}" for i in idxs]
                )
        n = self.engine.step_samples
        # find ready slots BEFORE allocating the batch: the ticker polls
        # every 5 ms, and allocating a (B, step) zero array per idle poll
        # is ~GB/s of pure host allocation churn at batch 256
        ready = [
            (i, self.slots[i])
            for i in range(lo, lo + b)
            if self.slots[i] is not None
            and self.slots[i].buffer.shape[0] >= n
        ]
        if not ready:
            self._wave_t0[cohort] = None
            return
        # Optional wave coalescing (fast-poll mode, opt-in via
        # ``coalesce``; see the class docstring for the measured tradeoff):
        # hold a partial wave until every active slot is ready, but never
        # past the age cap (stragglers / clients draining their last
        # replies must not stall the batch), and never when someone is
        # falling behind (>= 2 blocks queued — overload: dispatch now).
        # realtime mode polls once per step already.
        if self.coalesce > 0 and not self.realtime:
            partial = len(ready) < sum(
                self.slots[i] is not None for i in range(lo, lo + b)
            )
            if partial and not any(
                s.buffer.shape[0] >= 2 * n for _, s in ready
            ):
                now = time.monotonic()
                if self._wave_t0[cohort] is None:
                    self._wave_t0[cohort] = now
                if now - self._wave_t0[cohort] < self.coalesce:
                    return
        self._wave_t0[cohort] = None
        blocks = np.zeros((b, n), self._ingest_dtype)
        present = np.zeros((b,), bool)
        clients = {}
        for i, slot in ready:
            lane = i - lo
            blocks[lane] = slot.buffer[:n]
            slot.buffer = slot.buffer[n:]
            present[lane] = True
            clients[lane] = slot
        loop = asyncio.get_running_loop()
        if not self.pipelined:
            # default synchronous path: the tick blocks on the full push
            # (device step + fetch + assembly) before sending this hop's
            # replies (see the class docstring)
            outputs = await loop.run_in_executor(
                self._dispatch_pool, session.push_rttm, blocks, present
            )
            await self._send_outputs(outputs, clients)
            return
        # Pipelined serving (opt-in; an overload-throughput mode): the
        # tick only DISPATCHES the hop (push_begin, serialized on its own
        # one-thread pool — state threading must stay in order); the
        # blocking device->host fetch + RTTM assembly (push_finish) runs
        # on a second one-thread pool and the replies are sent by the
        # _deliverer task. Hop k's fetch and emission overlap hop k+1's
        # dispatch; both pools being single threads keeps begins serial
        # and finishes in dispatch order (so per-client reply order is
        # preserved). The bounded queue backpressures the ticker if
        # harvests ever fall behind.
        pending = await loop.run_in_executor(
            self._dispatch_pool, session.push_begin, blocks, present
        )
        if pending is None:
            return
        fut = loop.run_in_executor(
            self._harvest_pools[cohort], session.push_finish_rttm, pending
        )
        self._in_flight += 1
        if self._outbox is None:
            # _tick called outside serve() (unit tests drive it directly):
            # create the queue here; serve() rebinds a fresh one to its own
            # running loop before the ticker starts
            self._outbox = asyncio.Queue(maxsize=1)
        await self._outbox.put((fut, clients))

    async def _send_outputs(self, outputs, clients):
        """Send each client its hop's RTTM text (``session.push_rttm`` /
        ``push_finish_rttm`` output: one string per stream, skipping the
        Annotation object churn the wire never needed).

        Slow-consumer eviction: ``websocket.send`` blocks when a client's
        TCP write buffer is full (websockets flow control), and one
        stalled client must NOT stall the hop for everyone else — the
        sends of one hop run concurrently, each capped at a step period;
        a client that can't drain an RTTM line within a full step is
        evicted (closed 1011) and its slot recycled."""
        timeout = max(self.engine.step_duration, 0.25)

        async def send_one(slot, rttm):
            try:
                await asyncio.wait_for(slot.websocket.send(rttm), timeout)
            except asyncio.TimeoutError:
                logger.warning(
                    "slot %d cannot keep up; evicting", slot.index
                )
                try:
                    await asyncio.wait_for(
                        slot.websocket.close(code=1011, reason="too slow"),
                        1.0,
                    )
                except Exception:
                    pass
            except Exception:
                pass

        sends = [
            send_one(clients[i], rttm)
            for i, rttm in enumerate(outputs)
            if rttm and i in clients
        ]
        if sends:
            await asyncio.gather(*sends)

    async def _deliverer(self):
        """Consume harvested hops in order and send each client its RTTM."""
        while True:
            fut, clients = await self._outbox.get()
            try:
                outputs = await fut
                await self._send_outputs(outputs, clients)
            except Exception:
                logger.exception("hop harvest failed")
            finally:
                self._in_flight -= 1

    async def _ticker(self):
        # Realtime: each cohort ticks once per step period, staggered at
        # phase j * step / cohorts — the device time-multiplexes K hops
        # across the period instead of idling through most of it.
        # The schedule is ABSOLUTE deadlines (t0 + p*step + j*phase, the
        # same schedule CohortScheduler runs) — a relative sleep-after-work loop would accumulate
        # every tick's work time as permanent drift, and since each tick
        # consumes at most one block per stream, drifted time could never
        # be caught up. With deadlines, a late tick is followed by
        # back-to-back ticks until the schedule is current again.
        # Fast poll: round-robin every cohort per 5 ms poll (a cohort with
        # no ready slot returns immediately).
        if self.realtime:
            step = self.engine.step_duration
            phase = step / self.cohorts
            t0 = time.monotonic()
            k = 0  # global tick index: period k // cohorts, cohort k % cohorts
            while not self._stop.is_set():
                due = (
                    t0
                    + (k // self.cohorts) * step
                    + (k % self.cohorts) * phase
                )
                delay = due - time.monotonic()
                if delay > 0:
                    try:
                        await asyncio.wait_for(
                            self._stop.wait(), timeout=delay
                        )
                        break  # stop requested during the wait
                    except asyncio.TimeoutError:
                        pass
                await self._tick(k % self.cohorts)
                k += 1
        else:
            while not self._stop.is_set():
                for j in range(self.cohorts):
                    await self._tick(j)
                try:
                    await asyncio.wait_for(self._stop.wait(), timeout=0.005)
                except asyncio.TimeoutError:
                    pass
        # drain in-flight hops so the last replies still go out (counter,
        # not queue emptiness: the deliverer pops an item BEFORE awaiting
        # its harvest, so an empty queue can still have a hop in flight).
        # Bounded: a wedged device must not hang shutdown forever —
        # after a few step periods, log and abandon the remaining hops.
        deadline = time.monotonic() + max(3 * self.engine.step_duration, 2.0)
        while self._in_flight > 0:
            if time.monotonic() > deadline:
                logger.warning(
                    "shutdown drain timed out with %d hop(s) still in "
                    "flight; abandoning their replies",
                    self._in_flight,
                )
                break
            await asyncio.sleep(0.05)

    # ------------------------------------------------------------------ #
    async def serve(self, warm: bool = True):
        import websockets

        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        # fresh pools per serve() run (the finally below shuts them down so
        # worker threads don't outlive the server; __init__ also creates a
        # pair so _tick works without serve, e.g. in unit tests — an
        # unused ThreadPoolExecutor spawns no threads)
        from concurrent.futures import ThreadPoolExecutor

        self._dispatch_pool.shutdown(wait=False)
        for pool in self._harvest_pools:
            pool.shutdown(wait=False)
        self._dispatch_pool = ThreadPoolExecutor(1, "diart-dispatch")
        self._harvest_pools = [
            ThreadPoolExecutor(1, f"diart-harvest-{j}")
            for j in range(self.cohorts)
        ]
        # Bounded in-flight hops (each pins its device tensors until
        # harvested); the put() in _tick backpressures past this depth.
        # Depth 1 PER COHORT = exactly one hop of each cohort harvesting
        # while its next dispatches; a deeper queue only adds wire latency
        # (harvests queue behind dispatches).
        self._outbox = asyncio.Queue(maxsize=self.cohorts)
        # a previous serve() run may have abandoned its drain (wedged
        # device); a stale count would make THIS run's shutdown drain
        # always burn its full deadline
        self._in_flight = 0
        deliverer = asyncio.create_task(self._deliverer())
        async with websockets.serve(self._handler, self.host, self.port):
            logger.info("serving on %s:%d", self.host, self.port)
            if warm:
                # build the kernels and the native assembler and run the
                # step, every fetch route and the churn reset BEFORE the
                # first tick — a first-use kernel build takes seconds, and
                # an admission storm of fresh clients would pay it
                # mid-stream otherwise. Listening already: clients can
                # connect during the warm; their audio buffers until the
                # ticker starts.
                logger.info("warming the serving path...")
                # one warm covers every cohort: kernels are per-process and
                # warm() runs on scratch state
                await self._loop.run_in_executor(None, self.session.warm)
            try:
                await self._ticker()
            finally:
                deliverer.cancel()
                # don't leak the worker threads across server lifetimes
                # (each instance would otherwise pin threads until
                # interpreter exit)
                self._dispatch_pool.shutdown(wait=False)
                for pool in self._harvest_pools:
                    pool.shutdown(wait=False)

    def run(self):
        """Blocking entry point."""
        asyncio.run(self.serve())

    def close(self):
        """Stop the server (thread-safe)."""
        if self._stop is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
