"""Host milliseconds of the program's ``step.clustering`` span: queuing the
clustering, the score ring, the aggregation and the new state; the median
over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.host_ms(r, "step.clustering")
