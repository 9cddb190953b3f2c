"""Device milliseconds of a hop's segmentation: from the step's start to
after the segmentation model (the blocks' copy, the audio ring, the
SincNet, the BiLSTM sweeps, the classifier), between the engine's timing
events on the step's stream; the median over the traced window's hops.
Closed loop: the card runs hops back to back, so the interval holds the
phase's work and no wait for the host."""

from portbench.metrics import _program


def read(r):
    return _program.device_ms(r, "segmentation_ms")
