"""Device milliseconds of a hop's embedding: from after the segmentation to
after the embedding's normalization (the overlapped-speech weights, the
trunk, the statistics head), between the engine's timing events; the
median over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.device_ms(r, "embedding_ms")
