"""The embedding's hand-written kernels' share of their roofline, summed:
``linear_stats`` in the x-vector; the three ``se_res2`` blocks' launches
and ``attn_stats`` in ECAPA. The sum of their least times over the sum of
their device times by name, in percent."""

from portbench.metrics import _roofline


def read(r):
    return _roofline.share(r, lambda k: k["role"] == "embedding")
