"""SincNet's second and third stages (the ``sinc_stages`` kernels) against
their roofline: the least time of a hop's launch sets, times the hops
harvested in the traced window, over the device time of the kernels named
``sinc_stage`` there (norm1's statistics and the two convolutions), in
percent; None where no such kernel ran.

A hop launches one set for the segmentation's SincNet and one more where the
embedding is the SincNet x-vector. A set's least time is the larger of its
products, conv2 (80 -> 60, k = 5) and conv3 (60 -> 60, k = 5) over their
output frames at the model's precision (f32: three TF32 products), and its
bytes: the pooled input (B, 80, P1) f32 read once and the (B, 60, P3) f32
output written once. The entry is built here, not in ``portbench/work``,
whose ``role`` would add the x-vector's set to the embedding's kernels; the
pattern matches none of ``sinc_frontend``'s kernel names."""

import types

from portbench.metrics import _roofline
from portbench.work import conv
from portbench.work.pyannet import sincnet_frames

FILTERS, CHANNELS, TAPS = 80, 60, 5
SINCNETS = {"PyanNet": 1, "XVectorSincNet": 1}  # the model classes with a SincNet frontend


def launch(batch: int, precision: str = "f32") -> dict:
    """One launch set's work at ``batch`` streams of 5 s."""
    _, p1, c2, _, c3, p3 = sincnet_frames()
    flops = batch * (conv(FILTERS, CHANNELS, TAPS, c2) + conv(CHANNELS, CHANNELS, TAPS, c3))
    nbytes = 4.0 * batch * (FILTERS * p1 + CHANNELS * p3)
    return dict(name="sinc_stages", pattern=r"sinc_stage", precision=precision, flops=flops, bytes=nbytes)


def launches(config: dict) -> list:
    """The hop's launch sets under ``config``'s models, each at its model's
    precision."""
    return [config[role]["dtype"] for role in ("segmentation", "embedding")
            for _ in range(SINCNETS.get(config[role]["class"], 0))]


def read(r):
    kernels = [launch(r.batch, precision) for precision in launches(r.config)]
    if not kernels:
        return None
    return _roofline.share(types.SimpleNamespace(**{**vars(r), "kernels": kernels}), lambda k: True)
