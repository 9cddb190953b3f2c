"""Host milliseconds of the program's ``step.embedding`` span: queuing the
overlapped-speech weights, the embedding's trunk and head and the
normalization; the median over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.host_ms(r, "step.embedding")
