"""The ``sinc_frontend_roofline`` reader on synthetic traces: its bound at
B=256, the launches a hop under each configuration, and no reading where
no ``sinc_frontend`` kernel ran."""

import json
import types

import pytest

from portbench.cell import HERE
from portbench.run import metric_reader


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _readings(config, launch_ms, hops, names=("(anonymous namespace)::sinc_frontend_kernel(float const*)",)):
    """A traced window of ``hops`` hops at B=256 whose device list holds, a
    hop, one event of ``launch_ms`` per name."""
    device, t = [], 1000.0
    for _ in range(hops):
        for name in names:
            device.append((name, t, t + launch_ms * 1e3))
            t += launch_ms * 1e3 + 10.0
        device.append(("void cudnn::other_kernel()", t, t + 500.0))
        t += 600.0
    return types.SimpleNamespace(config=config, batch=256, hops=hops, window=(0.0, t + 1.0), device=device,
                                 kernels=[])


def test_bound_at_b256():
    from portbench.metrics import sinc_frontend_roofline as m
    from portbench.work import kernel_bound_s

    k = m.launch(256)
    assert k["flops"] == pytest.approx(2 * (40 * 126 + 40 * 125) * 3 * 2658 * 256)
    assert k["bytes"] == 4 * 256 * 80000 + 4 * 256 * 80 * 2658
    assert kernel_bound_s(k) == pytest.approx(0.248e-3, rel=2e-3)  # products, over the 0.089 ms of bytes


@pytest.mark.parametrize("config,sincnets", [("pyannet-xvector", 2), ("pyannet-ecapa-bf16", 1)])
def test_launches_a_hop(config, sincnets):
    read = metric_reader("sinc_frontend_roofline")
    cfg = _config(config)
    names = ("sinc_frontend_kernel",) * sincnets
    got = read(_readings(cfg, 1.0, 10, names))
    assert got == pytest.approx(100 * 0.24843 / 1.0, rel=1e-3)  # every launch of the hop counted once
    # twice the device time a launch: half the share
    half = read(_readings(cfg, 2.0, 10, names))
    assert half == pytest.approx(got / 2, rel=1e-9)


def test_none_without_the_kernel():
    read = metric_reader("sinc_frontend_roofline")
    r = _readings(_config("pyannet-xvector"), 1.0, 10, names=())
    assert read(r) is None
    r = _readings(_config("pyannet-xvector"), 5.5, 10,
                  names=("sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcrs",))
    assert read(r) is None
