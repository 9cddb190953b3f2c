"""Host milliseconds of the program's ``session.assemble`` span: the RTTM
texts assembled from a harvested hop (the native assembler and the
first-chunk route); the median over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.host_ms(r, "session.assemble")
