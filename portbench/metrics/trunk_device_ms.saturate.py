"""Device milliseconds of a hop's embedding trunk: from after the
segmentation to where the trunk returns (the overlapped-speech weights,
the frame ring's normalization, the trunk), between the engine's timing
events; the median over the traced window's hops."""

import statistics

from portbench.metrics import _trunk


def read(r):
    ms = _trunk.trunk_ms(r)
    return statistics.median(ms) if ms else None
