"""The work counters against hand counts at small shapes, and every share of
a roofline at or under 100% against the kernels' measured times."""

import json

import pytest

from portbench import work
from portbench.cell import HERE
from portbench.work import ecapa, pyannet, xvector

PARTS = {"sinc": "f32", "frontend": "bf16", "segmentation": "f32", "lstm": "bf16",
         "embedding": "f32", "fbank": "f32", "attention": "f32"}
SEG = {"num_speakers": 4, "lstm_hidden": 128, "lstm_layers": 4, "linear_dims": [128, 128]}


def test_conv_and_frames_by_hand():
    assert work.conv(2, 3, 5, 7) == 2 * 2 * 3 * 5 * 7
    assert pyannet.sincnet_frames() == (7975, 2658, 2654, 884, 880, 293)
    assert [t for _, t in xvector.tdnn_frames()] == [289, 285, 279, 279, 279]


def test_lstm_sweep_by_hand():
    """One launch a layer: 2 directions x T x B x (2 x 4H x H) operations;
    the bf16 gate stream (T, 2, B, 4H) and w_hh read, (T, 2, B, H) written."""
    args = dict(SEG, lstm_hidden=2, lstm_layers=1)
    (k,) = pyannet.kernels(args, PARTS, batch=3)
    assert k["flops"] == 2 * 293 * 3 * 2 * 8 * 2
    assert k["bytes"] == 2 * (293 * 2 * 3 * 8 + 2 * 8 * 2 + 293 * 2 * 3 * 2)
    assert k["precision"] == "bf16"


def test_segmentation_flops_by_hand():
    f = pyannet.flops(dict(SEG, lstm_hidden=2, lstm_layers=1, linear_dims=[3]), PARTS)
    lstm = 2 * 2 * 293 * 8 * (60 + 2)
    assert f["bf16"] == lstm
    sinc = 2 * 80 * 251 * 7975
    convs = 2 * 80 * 60 * 5 * 2654 + 2 * 60 * 60 * 5 * 880
    linear = 2 * 293 * (4 * 3 + 3 * 4)
    assert f["f32"] == sinc + convs + linear


def test_linear_stats_by_hand():
    (k,) = xvector.kernels({"embedding_dim": 512}, PARTS, batch=2)
    assert k["flops"] == 2 * 2 * 279 * 512 * 1500 + 2 * 2 * 2 * 4 * 279 * 1500
    assert k["bytes"] == 4 * 2 * 279 * 512 + 4 * (512 * 1500 + 2 * 4 * 279 + 2 * 2 * 4 * 1500)


def test_peaks():
    assert work.PRODUCT_PEAK["f32"] == pytest.approx(165e12)
    assert work.kernel_bound_s(dict(flops=989e12, bytes=0, precision="bf16")) == pytest.approx(1.0)
    assert work.kernel_bound_s(dict(flops=0, bytes=3.35e12, precision="f32")) == pytest.approx(1.0)
    assert work.bound_ms(3.35e9, 0, "bf16") == (pytest.approx(1.0), "bytes")
    assert work.tf32_bounds(0, 495e9)[0][0] == pytest.approx(3.0)


# the kernels' device ms at B=64 measured on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6): the least time the counters give must not exceed them
MEASURED_B64 = [
    ("lstm_sweep", pyannet, SEG, dict(PARTS), 0.168),
    ("lstm_sweep", pyannet, SEG, dict(PARTS, lstm="f32"), 0.327),
    ("linear_stats", xvector, {"embedding_dim": 512}, dict(PARTS), 0.4853),
    ("linear_stats", xvector, {"embedding_dim": 512}, dict(PARTS, embedding="bf16"), 0.0897),
    ("se_res2", ecapa, {"channels": 512, "embedding_dim": 192}, dict(PARTS, embedding="bf16"), 0.248),
    ("attn_stats", ecapa, {"channels": 512, "embedding_dim": 192}, dict(PARTS, embedding="bf16"), 0.252),
]


@pytest.mark.parametrize("name, fam, args, parts, ms", MEASURED_B64)
def test_share_at_most_100(name, fam, args, parts, ms):
    k = next(k for k in fam.kernels(args, parts, batch=64) if k["name"] == name)
    share = work.kernel_bound_s(k) / (ms * 1e-3)
    assert 0 < share <= 1.0


def test_hop_work_splits_roles():
    config = json.loads((HERE / "configs" / "pyannet-ecapa-bf16.json").read_text())
    flops, kernels = work.hop_work(config, 256)
    assert {k["role"] for k in kernels} == {"segmentation", "embedding"}
    assert [k["name"] for k in kernels].count("se_res2") == 3 and flops["bf16"] > flops["f32"] > 0
