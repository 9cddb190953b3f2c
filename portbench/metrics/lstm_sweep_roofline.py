"""The BiLSTM sweep kernel's share of its roofline: the least time of its
launches in the window (operations at the stated precision's peak, or its
gate stream read and hidden states written once over HBM) over their device
time by name in the profiler, in percent."""

from portbench.metrics import _roofline


def read(r):
    return _roofline.share(r, lambda k: k["name"] == "lstm_sweep")
