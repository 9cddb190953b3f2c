"""SincNet's first stage (the ``sinc_frontend`` kernel) against its
roofline: the least time of a hop's launches, times the hops harvested in
the traced window, over the device time of the kernels named
``sinc_frontend`` there, in percent; None where no such kernel ran.

A hop launches it once for the segmentation's SincNet and once more where
the embedding is the SincNet x-vector. A launch's least time is the larger
of its folded products at the f32 product peak (``kernel_bound_s``: each
filter folded about its centre tap, 2 x (40 x 126 + 40 x 125) operations a
computed frame, 3 (T // 3) frames a stream) and its bytes (the waveform read
and the pooled output written once). The entry is built here, not in
``portbench/work``, whose ``role`` would add the x-vector's launch to the
embedding's kernels."""

import types

from portbench.metrics import _roofline
from portbench.work.pyannet import SAMPLES, sincnet_frames

FILTERS, KERNEL = 80, 251
SINCNETS = {"PyanNet": 1, "XVectorSincNet": 1}  # the model classes with a SincNet frontend


def launch(batch: int) -> dict:
    """One launch's work at ``batch`` streams of 5 s."""
    pooled = sincnet_frames()[1]
    half = FILTERS // 2
    flops = 2.0 * (half * (KERNEL // 2 + 1) + half * (KERNEL // 2)) * 3 * pooled * batch
    nbytes = 4.0 * batch * SAMPLES + 4.0 * batch * FILTERS * pooled
    return dict(name="sinc_frontend", pattern=r"sinc_frontend", precision="f32", flops=flops, bytes=nbytes)


def launches(config: dict) -> int:
    """The hop's launches under ``config``'s models."""
    return sum(SINCNETS.get(config[role]["class"], 0) for role in ("segmentation", "embedding"))


def read(r):
    kernels = [launch(r.batch) for _ in range(launches(r.config))]
    if not kernels:
        return None
    return _roofline.share(types.SimpleNamespace(**{**vars(r), "kernels": kernels}), lambda k: True)
