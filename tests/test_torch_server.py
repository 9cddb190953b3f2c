"""The port's ``StreamingServer`` (``diart_tpu_torch.runtime.server``) on the
CPU: the JAX package's server tests that need no mesh (from
``tests/test_tools.py``), ported, and a websocket run end to end against
diart_tpu's server.

Engines run the torch copies of ``tests/fakes.py``'s fake models
(``tests/test_torch_pipeline.py``) with ``device="cpu"``; diart_tpu's run
the JAX fakes on the JAX CPU backend. Tolerance everywhere: RTTM text
string-equal (the fakes' tones sit far from every threshold). Servers bind
ephemeral ports on 127.0.0.1.
"""

import asyncio
import socket
import threading
import time

import numpy as np
import pytest
import torch

from diart_tpu_torch.parallel import MultiStreamEngine, MultiStreamSession
from diart_tpu_torch.runtime.server import StreamingServer, _ClientSlot
from diart_tpu_torch.utils import encode_audio, encode_audio_int16

from fakes import SAMPLE_RATE, Turn, synth_audio
from test_torch_pipeline import fake_embedding, fake_segmentation

FILES = {
    "conv1": [Turn(0.0, 3.0, 0), Turn(4.0, 7.0, 1)],
    "conv2": [Turn(0.5, 2.5, 2), Turn(3.0, 6.0, 0), Turn(6.5, 8.0, 2)],
}
TOTAL = 8.0
PARAMS = dict(duration=2.0, step=0.5, latency=0.5, tau_active=0.6, rho_update=0.1,
              delta_new=0.7, max_speakers=8, sample_rate=SAMPLE_RATE)
STEP = int(PARAMS["step"] * SAMPLE_RATE)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_engine(batch_size: int) -> MultiStreamEngine:
    return MultiStreamEngine(segmentation=fake_segmentation(), embedding=fake_embedding(),
                             batch_size=batch_size, **PARAMS)


def audios():
    return {uri: synth_audio(turns, TOTAL, seed=i) for i, (uri, turns) in enumerate(FILES.items())}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_clients(server, streams, formats=None):
    """Run ``server`` on a thread, connect one websocket client per stream
    in order (each after the previous one holds its slot, so client ``i``
    is slot ``i``), stream each client's audio and return each client's
    received messages once its replies have gone quiet for 2 s."""
    from websockets.sync.client import connect

    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    deadline = time.time() + 30
    while True:
        try:
            socket.create_connection((server.host, server.port), 0.5).close()
            break
        except OSError:
            assert time.time() < deadline, "server never listened"
            time.sleep(0.05)
    sockets = {}
    for name in streams:
        sockets[name] = connect(f"ws://{server.host}:{server.port}")
        deadline = time.time() + 30
        while sum(slot is not None for slot in server.slots.values()) < len(sockets):
            assert time.time() < deadline, "a client never got its slot"
            time.sleep(0.01)
    received = {name: [] for name in streams}

    def client(name):
        fmt = (formats or {}).get(name, "f32")
        encode = encode_audio_int16 if fmt == "int16" else encode_audio
        audio = streams[name]
        with sockets[name] as ws:
            if fmt == "int16":
                ws.send('{"format": "int16"}')
            for start in range(0, audio.shape[1], STEP):
                ws.send(encode(audio[:, start : start + STEP]))
                time.sleep(0.01)
            deadline = time.time() + 30
            while time.time() < deadline:
                try:
                    received[name].append(ws.recv(timeout=2.0))
                except TimeoutError:
                    if received[name]:
                        break
                except Exception:
                    break

    threads = [threading.Thread(target=client, args=(n,)) for n in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    server.close()
    thread.join(timeout=10)
    assert not thread.is_alive() and not any(t.is_alive() for t in threads)
    return received


def session_texts(engine, streams, lanes, uris, quantize=False):
    """The text a MultiStreamSession gives each stream when pushed the
    same step blocks from this thread (stream ``name`` in lane
    ``lanes[name]``), with the server's uri for it."""
    session = MultiStreamSession(engine, uris=uris, tau_active=PARAMS["tau_active"],
                                 collect_audio=False, quantize_transfer=quantize)
    hops = max(a.shape[1] for a in streams.values()) // STEP
    out = {name: "" for name in streams}
    for k in range(hops):
        blocks = np.zeros((engine.batch_size, STEP), np.float32)
        present = np.zeros(engine.batch_size, bool)
        for name, audio in streams.items():
            block = audio[0, k * STEP : (k + 1) * STEP]
            if block.shape[0] == STEP:
                blocks[lanes[name]], present[lanes[name]] = block, True
        texts = session.push_rttm(blocks, present)
        for name in streams:
            out[name] += texts[lanes[name]] or ""
    return out


# --------------------------------------------------------------------- #
# Websocket runs end to end
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pipelined", [False, True])
def test_websocket_end_to_end_matches_jax_server(pipelined):
    """Two clients on diart_tpu's server and on the port's (B=2): each
    client's RTTM text (uri ``client<slot>`` included) is equal, with
    turns, in the synchronous and the pipelined modes."""
    from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
    from diart_tpu.runtime.server import StreamingServer as JaxStreamingServer

    import fakes

    streams = audios()
    texts = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            engine = JaxMultiStreamEngine(segmentation=fakes.fake_segmentation(),
                                          embedding=fakes.fake_embedding(), batch_size=2, **PARAMS)
            server_cls = JaxStreamingServer
        else:
            engine, server_cls = make_engine(2), StreamingServer
        server = server_cls(engine, tau_active=0.6, host="127.0.0.1", port=free_port(),
                            realtime=False, pipelined=pipelined)
        received = serve_clients(server, streams)
        texts[pkg] = {name: "".join(msgs) for name, msgs in received.items()}
    for name in FILES:
        assert texts["port"][name].count("SPEAKER") >= 2
    assert texts["port"] == texts["jax"]
    assert "client0" in texts["port"]["conv1"] and "client1" in texts["port"]["conv2"]


def test_cohort_serving():
    """cohorts=2 with batch_size=1: two concurrent clients, the second in
    cohort 1 lane 0, each on its own session of the one engine; each
    client's text equals a session pushed the same blocks from the main
    thread."""
    engine = make_engine(1)
    server = StreamingServer(engine, tau_active=0.6, host="127.0.0.1", port=free_port(),
                             realtime=False, cohorts=2)
    streams = audios()
    received = serve_clients(server, streams)
    for j, name in enumerate(FILES):
        want = session_texts(engine, {name: streams[name]}, {name: 0}, [f"client{j}"])[name]
        assert "".join(received[name]) == want
        assert want.count("SPEAKER") >= 2


def test_wire_int16_parity():
    """An int16-wire client and a float32-wire client sending the same
    int16-exact audio to a quantize_transfer server get the same text
    (apart from the slot's uri), which equals a quantize_transfer session
    pushed the float blocks from the main thread."""
    engine = make_engine(2)
    server = StreamingServer(engine, tau_active=0.6, host="127.0.0.1", port=free_port(),
                             realtime=False, quantize_transfer=True)
    raw = synth_audio(FILES["conv1"], TOTAL, seed=0)
    audio = np.clip(raw * 32768.0, -32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    received = serve_clients(server, {"f32": audio, "int16": audio},
                             formats={"f32": "f32", "int16": "int16"})
    want = session_texts(engine, {"f32": audio}, {"f32": 0}, ["client0", "client1"], quantize=True)
    assert "".join(received["f32"]) == want["f32"]
    assert "".join(received["int16"]) == want["f32"].replace("client0", "client1")
    assert want["f32"].count("SPEAKER") >= 2


# --------------------------------------------------------------------- #
# The tick, the handler and the sends without a websocket
# --------------------------------------------------------------------- #
def test_wave_coalescing():
    """With ``coalesce`` set, fast-poll ticks collapse one synchronized
    client wave into ONE dispatched hop: a partial ready set is held until
    every active slot is ready, but never past the age cap, and never when
    a client is falling behind (>= 2 blocks queued). With coalesce=0,
    partial waves dispatch immediately."""
    engine = make_engine(4)
    hold = 0.25 * PARAMS["step"]
    server = StreamingServer(engine, tau_active=0.6, realtime=False, coalesce=hold)
    pushes = []

    def fake_push(blocks, present):
        pushes.append(present.copy())
        return [None] * engine.batch_size

    server.session.push_rttm = fake_push
    server.session.reset_slots = lambda *a, **k: None
    n = engine.step_samples

    def set_slots(*block_counts):
        server.slots = {i: None for i in range(engine.batch_size)}
        for i, c in enumerate(block_counts):
            if c is None:
                continue
            slot = _ClientSlot(i, websocket=None)
            slot.buffer = np.zeros((c * n,), np.float32)
            server.slots[i] = slot
        server._pending_resets[0].clear()
        server._wave_t0[0] = None

    tick = lambda: asyncio.run(server._tick())

    set_slots(1, 1, 1, None)
    tick()
    assert len(pushes) == 1 and pushes[0].sum() == 3

    set_slots(1, 1, 0, None)
    pushes.clear()
    tick()
    assert not pushes and server._wave_t0[0] is not None
    tick()
    assert not pushes
    server._wave_t0[0] -= hold + 0.01
    tick()
    assert len(pushes) == 1 and pushes[0].sum() == 2

    set_slots(2, 1, 0, None)
    pushes.clear()
    tick()
    assert len(pushes) == 1 and pushes[0].sum() == 2

    set_slots(1, 1, 0, None)
    pushes.clear()
    tick()
    assert not pushes
    server.slots[2].buffer = np.zeros((n,), np.float32)
    tick()
    assert len(pushes) == 1 and pushes[0].sum() == 3

    server.coalesce = 0.0
    set_slots(1, 1, 0, None)
    pushes.clear()
    tick()
    assert len(pushes) == 1 and pushes[0].sum() == 2


class _FakeSocket:
    def __init__(self, messages):
        self._messages = list(messages)
        self.close_code = None

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self._messages:
            raise StopAsyncIteration
        return self._messages.pop(0)

    async def close(self, code=1000, reason=""):
        self.close_code = code


def test_handshake_after_audio_rejected():
    """The {"format": ...} handshake must precede any audio (close 1002
    otherwise); one before audio is accepted; binary frames close 1003; a
    client far past real time is paused (backpressure), not evicted; every
    slot is released when its client goes."""
    engine = make_engine(2)
    server = StreamingServer(engine, realtime=False)
    audio = encode_audio(np.zeros((1, 64), np.float32))
    late = _FakeSocket([audio, '{"format": "int16"}'])
    asyncio.run(server._handler(late))
    assert late.close_code == 1002
    early = _FakeSocket(['{"format": "int16"}'])
    asyncio.run(server._handler(early))
    assert early.close_code is None
    unknown = _FakeSocket(['{"format": "mp3"}'])
    asyncio.run(server._handler(unknown))
    assert unknown.close_code == 1003
    binary = _FakeSocket([b"\x00\x01\x02\x03"])
    asyncio.run(server._handler(binary))
    assert binary.close_code == 1003
    n_cap = 4 * engine.chunk_samples
    flood = _FakeSocket([encode_audio(np.zeros((1, n_cap // 2), np.float32))] * 4)

    async def run_with_drain():
        task = asyncio.create_task(server._handler(flood))
        for _ in range(400):
            await asyncio.sleep(0.005)
            for slot in server.slots.values():
                if slot is not None and slot.buffer.shape[0] > n_cap:
                    slot.buffer = slot.buffer[-1:]  # ticker stand-in
            if task.done():
                break
        assert task.done(), "handler still paused after drains"
        await task

    asyncio.run(run_with_drain())
    assert flood.close_code is None
    assert all(slot is None for slot in server.slots.values())


def test_server_full_rejects_client():
    """With every slot taken, a new client is closed with 1013."""
    server = StreamingServer(make_engine(1), realtime=False)
    server._claim_slot(websocket=None)
    extra = _FakeSocket([])
    asyncio.run(server._handler(extra))
    assert extra.close_code == 1013


def test_pipelined_tick_without_serve():
    """A pipelined server's _tick driven directly creates its outbox
    lazily; a real hop lands there and its harvest gives the session's
    text."""
    engine = make_engine(2)
    server = StreamingServer(engine, realtime=False, pipelined=True)
    server.session.reset_slots = lambda *a, **k: None
    real_begin = server.session.push_begin
    server.session.push_begin = lambda blocks, present: None  # warm-up
    slot = _ClientSlot(0, websocket=None)
    slot.buffer = np.zeros((engine.step_samples,), np.float32)
    server.slots[0] = slot
    asyncio.run(server._tick())
    server.session.push_begin = lambda blocks, present: object()
    server.session.push_finish_rttm = lambda pending: ["x", None]
    slot.buffer = np.zeros((engine.step_samples,), np.float32)

    async def drive():
        await server._tick()
        assert server._outbox is not None
        assert server._outbox.qsize() == 1
        fut, clients = await server._outbox.get()
        assert await fut == ["x", None] and list(clients) == [0]

    asyncio.run(drive())
    assert real_begin is not None


def test_shutdown_drain_is_bounded():
    """A hop whose reply never lands does not hang shutdown: the drain
    gives up after a few step periods."""
    server = StreamingServer(make_engine(2), realtime=False)
    server._in_flight = 1

    async def drive():
        server._stop = asyncio.Event()
        server._stop.set()
        await asyncio.wait_for(server._ticker(), timeout=10.0)

    t0 = time.monotonic()
    asyncio.run(drive())
    assert time.monotonic() - t0 < 8.0


def test_slow_consumer_does_not_stall_the_hop():
    """A client whose send never completes is evicted (close 1011) after
    a step; the hop's other client still gets its text."""
    engine = make_engine(2)
    server = StreamingServer(engine, tau_active=0.6)

    class StuckSocket:
        def __init__(self):
            self.closed = None

        async def send(self, msg):
            await asyncio.sleep(3600)

        async def close(self, code=None, reason=None):
            self.closed = code

    class GoodSocket:
        def __init__(self):
            self.sent = []

        async def send(self, msg):
            self.sent.append(msg)

    stuck, good = _ClientSlot(0, StuckSocket()), _ClientSlot(1, GoodSocket())

    async def run():
        await asyncio.wait_for(
            server._send_outputs(["SPEAKER a\n", "SPEAKER b\n"], {0: stuck, 1: good}),
            timeout=3 * engine.step_duration)

    asyncio.run(run())
    assert good.websocket.sent == ["SPEAKER b\n"]
    assert stuck.websocket.closed == 1011


def test_realtime_ticker_staggers_cohorts():
    """In realtime mode with K cohorts the ticker fires one cohort per
    step / K, cycling 0..K-1."""
    server = StreamingServer(make_engine(1), realtime=True, cohorts=4)
    ticks = []

    async def fake_tick(cohort=0):
        ticks.append((cohort, time.perf_counter()))
        if len(ticks) >= 8:
            server._stop.set()

    server._tick = fake_tick

    async def drive():
        server._stop = asyncio.Event()
        await asyncio.wait_for(server._ticker(), timeout=10.0)

    asyncio.run(drive())
    assert [c for c, _ in ticks[:8]] == [0, 1, 2, 3, 0, 1, 2, 3]
    phase = PARAMS["step"] / 4
    gaps = [t1 - t0 for (_, t0), (_, t1) in zip(ticks, ticks[1:7])]
    assert all(0.5 * phase < g < 2.5 * phase for g in gaps), gaps


def test_stub_client_ticks_match_session():
    """The route the card's smoke run takes: in-process stub clients whose
    websocket only records what it is sent, driven by ``_tick`` for
    cohorts 1 and 2 (pipelined) on the float32 and int16 wires; each
    client's text equals a session pushed the same blocks from the main
    thread at the same phase."""
    engine = make_engine(2)
    streams = audios()
    names = list(streams)

    class StubSocket:
        def __init__(self):
            self.sent = []

        async def send(self, msg):
            self.sent.append(msg)

    for cohorts, pipelined, quantize in ((1, False, False), (2, True, True)):
        server = StreamingServer(engine, tau_active=0.6, cohorts=cohorts, pipelined=pipelined,
                                 quantize_transfer=quantize)
        clients = [server._claim_slot(StubSocket()) for _ in range(2 * cohorts)]
        feeds = [streams[names[i % 2]] for i in range(len(clients))]
        hops = feeds[0].shape[1] // STEP

        async def drive():
            for k in range(hops):
                for c, audio in zip(clients, feeds):
                    block = audio[:, k * STEP : (k + 1) * STEP]
                    c.buffer = np.concatenate([c.buffer, server._ingest(encode_audio(block), "f32")])
                for j in range(cohorts):
                    await server._tick(j)
                    while server._in_flight:  # the deliverer's part, in order
                        fut, slots = await server._outbox.get()
                        await server._send_outputs(await fut, slots)
                        server._in_flight -= 1

        asyncio.run(drive())
        for cohort in range(cohorts):
            lanes = {names[i]: i for i in range(2)}
            uris = [f"client{cohort * 2 + i}" for i in range(2)]
            want = session_texts(engine, {n: streams[n] for n in names}, lanes, uris, quantize)
            for i, name in enumerate(names):
                got = "".join(clients[cohort * 2 + i].websocket.sent)
                assert got == want[name] and got.count("SPEAKER") >= 2
