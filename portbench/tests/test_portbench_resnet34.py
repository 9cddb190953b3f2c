"""WeSpeaker ResNet34's benchmark files: its work counted against hand counts
at the published widths, the three readers of its trunk on synthetic
readings (silent where the trace or the port has nothing to read), its
configuration and its cell resolving by name, and a planted trunk fault
reading past the configuration's limits."""

import types

import pytest
import torch

from portbench import cell as cells
from portbench.run import metric_reader
from portbench.work import kernel_bound_s, resnet34

ARGS = {"embedding_dim": 256, "base_channels": 32, "depths": [3, 4, 6, 3], "num_mels": 80}
PARTS = {"fbank": "f32", "embedding": "bf16", "head": "f32"}


def test_trunk_work_by_hand():
    convs = resnet34.convs(ARGS)
    assert len(convs) == 36
    # the stem and stage 1 at 498 x 80 positions, then 249 x 40, 125 x 20, 63 x 10
    by_positions = {}
    for cin, cout, taps, _, p_out in convs:
        by_positions.setdefault(p_out, []).append((cin, cout, taps))
    assert sorted(by_positions, reverse=True) == [39840, 9960, 2500, 630]
    assert [len(by_positions[p]) for p in (39840, 9960, 2500, 630)] == [1 + 6, 9, 13, 7]
    # 11.3 GMAC a window
    assert resnet34.trunk_flops(ARGS) == pytest.approx(22.6e9, rel=2e-3)
    assert resnet34.pooled(ARGS) == (63, 2560)


def test_flops_by_precision():
    f = resnet34.flops(ARGS, PARTS)
    fbank = 50 * (2 * 2 * 256 * 400 + 2 * 256 * 80)
    head = 2 * 2 * 4 * 63 * 2560 + 2 * 4 * 5120 * 256
    assert f == {"f32": fbank + head, "bf16": resnet34.trunk_flops(ARGS)}
    assert resnet34.kernels(ARGS, PARTS, 256) == []


def test_trunk_least_time():
    """About 8.0 ms at B=256: stage 1's convolutions bound by their bytes
    (0.39 ms each), stages 3 and 4 by their products."""
    assert resnet34.trunk_least_s(ARGS, PARTS, 256) == pytest.approx(8.0e-3, rel=0.01)
    stage1 = dict(name="c", precision="bf16", flops=2.0 * 256 * 32 * 32 * 9 * 39840,
                  bytes=2 * (256 * 2 * 32 * 39840 + 32 * 32 * 9))
    assert kernel_bound_s(stage1) == pytest.approx(0.39e-3, rel=0.01)


def _phase(hop, trunk=None, field=True):
    p = types.SimpleNamespace(hop=hop, shard=None, segmentation_ms=1.0, embedding_ms=2.0, clustering_ms=0.5)
    if field:
        p.trunk_ms = trunk
    return p


def _readings(monkeypatch, phases, device=(), config="pyannet-resnet34-bf16", hops=3):
    from portbench.metrics import _program

    spans = [types.SimpleNamespace(name="session.dispatch", start=100.0 * k, end=100.0 * k + 10, hop=(0, k),
                                   thread=1) for k in range(hops)]
    got = (spans, list(phases)) if phases else None
    monkeypatch.setattr(_program, "program", lambda r: got)
    _, cfg, _ = cells.resolve("resnet34.saturate" if config == "pyannet-resnet34-bf16" else "ecapa.saturate")
    return types.SimpleNamespace(window=(0.0, 10_000.0), device=list(device), config=cfg, batch=256, hops=hops)


def test_trunk_readers(monkeypatch):
    r = _readings(monkeypatch, [_phase((0, 0), 40.0), _phase((0, 1), 50.0), _phase((0, 2), 45.0),
                                _phase((0, 9), 99.0)])
    assert metric_reader("trunk_device_ms.saturate")(r) == 45.0
    least = resnet34.trunk_least_s(ARGS, PARTS, 256)
    assert metric_reader("resnet_trunk_roofline")(r) == pytest.approx(100 * least / 45e-3)


def test_trunk_readers_silent(monkeypatch):
    """No phases; phases with no trunk event; a port whose DevicePhases has
    no ``trunk_ms`` (the parent's); another embedding than ResNet34."""
    for phases in ([], [_phase((0, 0))], [_phase((0, 0), field=False)]):
        r = _readings(monkeypatch, phases)
        assert metric_reader("trunk_device_ms.saturate")(r) is None
        assert metric_reader("resnet_trunk_roofline")(r) is None
    r = _readings(monkeypatch, [_phase((0, 0), 12.0)], config="pyannet-ecapa-bf16")
    assert metric_reader("trunk_device_ms.saturate")(r) == 12.0
    assert metric_reader("resnet_trunk_roofline")(r) is None


def test_layout_reader(monkeypatch):
    read = metric_reader("layout_ms.saturate")
    device = [("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(...)", 0.0, 300.0),
              ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>(...)", 400.0, 550.0),
              ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", 600.0, 5000.0),
              ("nchwToNhwcKernel", 20_000.0, 29_000.0)]  # outside the window
    r = _readings(monkeypatch, [], device=device)
    assert read(r) == pytest.approx(0.45 / 3)
    assert read(_readings(monkeypatch, [], device=device[2:3])) == 0.0
    assert read(_readings(monkeypatch, [], device=device[3:])) is None


def test_cells_resolve():
    cell, config, traffic = cells.resolve("resnet34.saturate")
    assert config["embedding"]["class"] == "ResNet34" and config["embedding"]["dtype"] == "bf16"
    assert config["reduced"] == [] and traffic["mode"] == "closed" and traffic["batch"] == 256
    assert config["precision_of_parts"]["embedding"] == "bf16"
    assert {config["precision_of_parts"][p] for p in ("fbank", "head")} == {"f32"}
    assert cell["chips"] == 1 and config["limits"] == {"score_gap": 5e-4, "cluster_gap": 3.5e-3}


def residual_left_out(engine):
    """One BasicBlock of the trunk's third stage adds no residual."""
    block = engine._emb.module.layer3_2
    block.forward = lambda x: torch.relu(block.bn2(block.conv2(torch.relu(block.bn1(block.conv1(x))))))


def test_trunk_fault_is_not_correct():
    from portbench.run import run_cell
    from portbench.tests.test_portbench_faults import SEED, small

    cell, config, traffic = small("resnet34.saturate")
    res = run_cell(cell, config, traffic, cells.load_benchmark(), SEED, 1.0, False, device="cpu",
                   fault=residual_left_out)
    gap = res["check"]["cluster_gap"]
    assert not res["correct"] and (gap["value"] == "inf" or gap["value"] > gap["limit"]), res["check"]
