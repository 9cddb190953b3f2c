"""Device milliseconds of a hop's clustering: from after the embedding to
the step's end (``cluster_step``, the score ring, the aggregation, the new
state), between the engine's timing events; the median over the traced
window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.device_ms(r, "clustering_ms")
