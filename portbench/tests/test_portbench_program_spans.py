"""The readers of the program's own spans and device phases
(``diart_tpu_torch.tracing``, recorded while ``torch.profiler`` runs), on
synthetic readings and on a tiny traced run on the CPU; on the card
(``-m card``), the one clock: a program span around a launched kernel holds
the kernel on the profiler's axis, and a saturate cell's three device
phases add up to its hop."""

import time
import types

import pytest

from portbench import cell as cells
from portbench import drive, trace
from portbench.metrics import _program
from portbench.run import metric_reader

BENCH = cells.load_benchmark()
NEW = {
    "segmentation_device_ms.saturate", "embedding_device_ms.saturate", "clustering_device_ms.saturate",
    "segmentation_dispatch_ms.realtime", "embedding_dispatch_ms.realtime", "clustering_dispatch_ms.realtime",
    "card_wait_ms.realtime", "assemble_ms.realtime", "idle_in_dispatch.realtime",
}
HOST = {"segmentation_dispatch_ms.realtime": "step.segmentation", "embedding_dispatch_ms.realtime": "step.embedding",
        "clustering_dispatch_ms.realtime": "step.clustering", "card_wait_ms.realtime": "session.wait_card",
        "assemble_ms.realtime": "session.assemble"}


def span(name, start, end, hop, thread=1):
    return types.SimpleNamespace(name=name, start=start, end=end, hop=hop, thread=thread)


def phases(hop, seg, emb, clu):
    return types.SimpleNamespace(hop=hop, shard=None, segmentation_ms=seg, embedding_ms=emb, clustering_ms=clu)


def readings(monkeypatch, program_spans, device_phases=(), device=(), window=(0.0, 10_000.0)):
    """Readings whose program recorded ``program_spans`` (already on the
    profiler's axis) and ``device_phases``; none where both are empty."""
    got = (list(program_spans), list(device_phases)) if program_spans or device_phases else None
    monkeypatch.setattr(_program, "program", lambda r: got)
    return types.SimpleNamespace(window=window, device=list(device))


def hop_spans(hop, t0, ms):
    """One hop's spans from ``t0`` us: the dispatch over its three phases
    (``ms`` of each), then the harvest's wait and assembly on thread 2."""
    seg, emb, clu, wait, asm = (x * 1e3 for x in ms)
    out = [span("step.segmentation", t0, t0 + seg, hop), span("step.embedding", t0 + seg, t0 + seg + emb, hop),
           span("step.clustering", t0 + seg + emb, t0 + seg + emb + clu, hop),
           span("session.dispatch", t0, t0 + seg + emb + clu, hop)]
    end = t0 + seg + emb + clu
    return out + [span("session.wait_card", end, end + wait, hop, 2),
                  span("session.assemble", end + wait, end + wait + asm, hop, 2)]


def test_entries_are_the_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert set(entries) == NEW
    for name, m in entries.items():
        assert m["source"] == "program_span" and callable(metric_reader(name))
        assert m["workloads"] == (["xvector.saturate", "ecapa.saturate"] if name.endswith(".saturate")
                                  else ["xvector.realtime"])


def test_host_readers_take_the_window_hops_median(monkeypatch):
    spans = hop_spans((0, 0), 1000.0, (2.0, 3.0, 1.0, 4.0, 0.5))
    spans += hop_spans((0, 1), 3000.0, (4.0, 5.0, 1.5, 6.0, 0.7))
    spans += hop_spans((0, 2), 5000.0, (6.0, 1.0, 2.0, 2.0, 0.9))
    # a hop dispatched before the window opened is left out
    spans += hop_spans((1, 0), -500.0, (90.0, 90.0, 90.0, 90.0, 90.0))
    r = readings(monkeypatch, spans)
    want = {"segmentation_dispatch_ms.realtime": 4.0, "embedding_dispatch_ms.realtime": 3.0,
            "clustering_dispatch_ms.realtime": 1.5, "card_wait_ms.realtime": 4.0, "assemble_ms.realtime": 0.7}
    for name, value in want.items():
        assert metric_reader(name)(r) == pytest.approx(value), name


def test_device_readers_take_the_window_hops_median(monkeypatch):
    spans = [span("session.dispatch", t, t + 10.0, (0, k)) for k, t in enumerate((100.0, 200.0, 300.0))]
    spans.append(span("session.dispatch", 20_000.0, 20_010.0, (0, 3)))
    r = readings(monkeypatch, spans, [phases((0, 0), 10.0, 20.0, 3.0), phases((0, 1), 12.0, 22.0, 2.0),
                         phases((0, 2), 11.0, 30.0, 4.0), phases((0, 3), 99.0, 99.0, 99.0)])
    assert metric_reader("segmentation_device_ms.saturate")(r) == 11.0
    assert metric_reader("embedding_device_ms.saturate")(r) == 22.0
    assert metric_reader("clustering_device_ms.saturate")(r) == 3.0


def test_idle_in_dispatch_counts_only_under_dispatch(monkeypatch):
    """Idle 100-300 and 600-700 us of a 1000 us window; a dispatch is open
    50-400; another thread's span covers 0-1000. Only 100-300 counts."""
    device = [("k", 0.0, 100.0), ("k", 300.0, 600.0), ("k", 700.0, 1000.0)]
    spans = [span("session.dispatch", 50.0, 400.0, (0, 0)), span("session.assemble", 0.0, 1000.0, (0, 0), 2)]
    read = metric_reader("idle_in_dispatch.realtime")
    at = lambda program: readings(monkeypatch, program, device=device, window=(0.0, 1000.0))
    assert read(at(spans)) == pytest.approx(20.0)
    assert read(at(spans[:1])) == pytest.approx(20.0)
    # a dispatch running past the window is clipped to it; two that overlap count once
    late = [span("session.dispatch", 650.0, 1500.0, (0, 1)), span("session.dispatch", 640.0, 660.0, (1, 0))]
    assert read(at(spans + late)) == pytest.approx(26.0)
    assert read(at(spans[1:])) is None


def test_readers_silent_without_the_recorder(monkeypatch):
    """A tree whose port records no span, or has no recorder at all, reads
    nothing and raises nothing."""
    r = readings(monkeypatch, [], device=[("k", 0.0, 10.0)])
    for name in NEW:
        assert metric_reader(name)(r) is None, name
    monkeypatch.undo()
    monkeypatch.setattr(drive, "SPANS", [("window", 1.0, 2.0)])
    monkeypatch.setitem(__import__("sys").modules, "diart_tpu_torch.tracing", None)
    r = types.SimpleNamespace(window=(0.0, 1e6), device=[("k", 0.0, 10.0)])
    for name in NEW:
        assert metric_reader(name)(r) is None, name


def test_program_spans_move_by_the_window(monkeypatch):
    """The port's spans move to the profiler's axis exactly as the
    harness's window span did, and keep their other fields."""
    from diart_tpu_torch import tracing
    from diart_tpu_torch.tracing import HopKey, Span

    record = types.SimpleNamespace(spans=[Span("session.dispatch", 2.001, 2.003, 7, HopKey(0, 0), None, 0)],
                                   phases=["phase"])
    monkeypatch.setattr(tracing, "last_profile", lambda: record)
    monkeypatch.setattr(drive, "SPANS", [("push_begin", 2.0, 2.0002), ("window", 2.0005, 2.004)])
    spans, phases = _program.program(types.SimpleNamespace(window=(5500.0, 9000.0)))
    assert spans == [Span("session.dispatch", pytest.approx(6000.0), pytest.approx(8000.0), 7, HopKey(0, 0),
                          None, 0)]
    assert phases == ["phase"]
    # nothing without a window on either clock
    assert _program.program(types.SimpleNamespace(window=None)) is None
    monkeypatch.setattr(drive, "SPANS", [])
    assert _program.program(types.SimpleNamespace(window=(5500.0, 9000.0))) is None


def test_traced_run_on_cpu_reads_the_program():
    """A tiny traced open-loop run on the CPU: the recorder's spans reach the
    readers (the device readers find nothing: a CPU has no device trace)."""
    from portbench.run import run_cell
    from portbench.tests.test_portbench_reference import small

    from diart_tpu_torch import tracing

    cell, config, traffic = small("xvector.realtime")
    res = run_cell(cell, config, traffic, BENCH, 2**31 + 17, 1.0, True, device="cpu")
    record = tracing.last_profile()
    lo, hi = trace.window_of(drive.SPANS)
    assert lo <= min(s.start for s in record.spans if s.name == "session.dispatch") < hi
    names = {s.name for s in record.spans}
    assert names == {"session.dispatch", "step.segmentation", "step.embedding", "step.clustering",
                     "session.wait_card", "session.assemble"}
    for name in HOST:
        assert name in res["metrics"] and res["metrics"][name]["value"] > 0, name
    steps = sum(res["metrics"][n]["value"] for n in ("segmentation_dispatch_ms.realtime",
                                                    "embedding_dispatch_ms.realtime",
                                                    "clustering_dispatch_ms.realtime"))
    dispatch = sorted(s.end - s.start for s in record.spans if s.name == "session.dispatch")
    assert steps <= dispatch[len(dispatch) // 2] * 1e3 * 1.05
    assert record.phases == [] and "segmentation_device_ms.saturate" not in res["metrics"]


@pytest.mark.card
def test_span_holds_its_kernel_on_card(card, monkeypatch):
    """A program span around one launched product and a synchronize holds
    the product's device interval on the mapped axis, within 50 us."""
    import torch

    from diart_tpu_torch import tracing as program

    x = torch.randn(4096, 4096, device=card)
    for _ in range(3):
        x @ x
    # the marker's own kernel, loaded before the profile: launched cold as
    # the marker, its first launch puts the card's axis 16-18 ms behind the
    # host's (a span around one product, NVIDIA H100)
    torch.zeros(1, device=card).add_(1.0)
    torch.cuda.synchronize()
    monkeypatch.setattr(drive, "SPANS", [])
    owner = object()
    with trace.profiled(True, card) as prof:
        t0 = time.perf_counter()
        with program.hop("probe", owner):
            x @ x
            torch.cuda.synchronize()
        drive.SPANS.append(("window", t0, time.perf_counter()))
    device, harness = trace.events(prof, list(drive.SPANS))
    (probe,) = _program.program(types.SimpleNamespace(window=trace.window_of(harness)))[0]
    assert device, "the profile holds no device operation besides the marker"
    for name, a, b in device:
        assert probe.start - 50.0 <= a and b <= probe.end + 50.0, (name, a, b, probe)


@pytest.mark.card
@pytest.mark.parametrize("name", ["xvector.saturate", "ecapa.saturate"])
def test_saturate_phases_add_up_to_the_hop(card, name):
    from diart_tpu_torch import tracing
    from portbench.run import run_cell

    cell, config, traffic = cells.resolve(name)
    res = run_cell(cell, config, traffic, BENCH, 2**31 + 107, 3.0, True, device=card)
    total = sum(res["metrics"][f"{p}_device_ms.saturate"]["value"] for p in ("segmentation", "embedding",
                                                                              "clustering"))
    # the closed loop's hops dispatched in the window are those harvested
    # in it: the one dispatched before it is harvested in it, the last one
    # after it
    lo, hi = trace.window_of(drive.SPANS)
    hops = sum(s.name == "session.dispatch" and lo <= s.start < hi for s in tracing.last_profile().spans)
    hop_ms = res["device"]["window_s"] / hops * 1e3
    assert abs(total - hop_ms) <= 0.05 * hop_ms, (total, hop_ms)
