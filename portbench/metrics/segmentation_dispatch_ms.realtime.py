"""Host milliseconds of the program's ``step.segmentation`` span: queuing
the blocks' copy, the audio ring's advance and the segmentation model; the
median over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.host_ms(r, "step.segmentation")
