"""The ``sinc_stages_roofline`` reader on synthetic traces: its bound at
B=256, the launch sets a hop under each configuration, no reading where no
``sinc_stage`` kernel ran, and its pattern and ``sinc_frontend_roofline``'s
each blind to the other's kernels."""

import json
import re
import types

import pytest

from portbench.cell import HERE
from portbench.run import metric_reader

STAGES = ("(anonymous namespace)::sinc_stage_stats(float const*, long long, float*, int, int)",
          "void (anonymous namespace)::sinc_stage2<false>(float const*, long long, float const*)",
          "void (anonymous namespace)::sinc_stage3<false>(float const*, float const*, float*)")
FRONTEND = "(anonymous namespace)::sinc_frontend_kernel(float const*, float const*, float*, int)"


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _readings(config, set_ms, hops, sets=1, names=STAGES):
    """A traced window of ``hops`` hops at B=256 whose device list holds, a
    hop, ``sets`` launch sets of ``names`` taking ``set_ms`` together, the
    first stage's kernel and a library kernel."""
    device, t = [], 1000.0
    for _ in range(hops):
        for _ in range(sets):
            for name in names:
                us = set_ms * 1e3 / len(names)
                device.append((name, t, t + us))
                t += us + 10.0
        for name in (FRONTEND, "void cudnn::other_kernel()"):
            device.append((name, t, t + 500.0))
            t += 600.0
    return types.SimpleNamespace(config=config, batch=256, hops=hops, window=(0.0, t + 1.0), device=device,
                                 kernels=[])


def test_bound_at_b256():
    from portbench.metrics import sinc_stages_roofline as m
    from portbench.work import kernel_bound_s

    k = m.launch(256)
    assert k["flops"] == pytest.approx(256 * (2 * 80 * 60 * 5 * 2654 + 2 * 60 * 60 * 5 * 880))
    assert k["flops"] == pytest.approx(40.7e9, rel=1e-3)
    assert k["bytes"] == 4 * 256 * (80 * 2658 + 60 * 293)
    assert k["bytes"] / 3.35e12 == pytest.approx(0.0704e-3, rel=2e-3)  # bytes: under the products' bound
    assert kernel_bound_s(k) == pytest.approx(0.247e-3, rel=2e-3)  # products: 3xTF32 at 495 TFLOP/s


@pytest.mark.parametrize("config,sets", [("pyannet-xvector", 2), ("pyannet-ecapa-bf16", 1),
                                         ("pyannet-resnet34-bf16", 1)])
def test_launch_sets_a_hop(config, sets):
    from portbench.metrics import sinc_stages_roofline as m
    from portbench.work import kernel_bound_s

    read = metric_reader("sinc_stages_roofline")
    cfg = _config(config)
    assert m.launches(cfg) == ["f32"] * sets
    got = read(_readings(cfg, 1.0, 10, sets))
    assert got == pytest.approx(100 * kernel_bound_s(m.launch(256)) / 1e-3, rel=1e-6)  # each set counted once
    assert read(_readings(cfg, 2.0, 10, sets)) == pytest.approx(got / 2, rel=1e-9)


def test_none_without_the_kernels():
    read = metric_reader("sinc_stages_roofline")
    assert read(_readings(_config("pyannet-xvector"), 1.0, 10, names=())) is None
    cudnn = ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>(int, int)",)
    assert read(_readings(_config("pyannet-ecapa-bf16"), 1.0, 10, names=cudnn)) is None


def test_patterns_are_blind_to_each_others_kernels():
    from portbench.metrics import sinc_frontend_roofline as frontend
    from portbench.metrics import sinc_stages_roofline as stages

    mine, theirs = stages.launch(256)["pattern"], frontend.launch(256)["pattern"]
    assert all(re.search(mine, name) for name in STAGES) and not re.search(mine, FRONTEND)
    assert re.search(theirs, FRONTEND) and not any(re.search(theirs, name) for name in STAGES)
    # and the first stage's reading is the same with the stages' kernels in the window as without
    cfg = _config("pyannet-ecapa-bf16")
    read = metric_reader("sinc_frontend_roofline")
    assert read(_readings(cfg, 1.0, 10)) == read(_readings(cfg, 1.0, 10, names=()))
