"""Device milliseconds a hop of cuDNN's tensor layout conversions (the
kernels that move a convolution's operands between NCHW and NHWC around
the 2-D trunk's convolutions), by name in the traced window; 0 where the
trace holds device operations but none of these, None where it holds
none."""

import re

LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw", re.IGNORECASE)


def read(r):
    lo, hi = r.window
    ops = [(name, s, e) for name, s, e in r.device if lo <= s < hi]
    if not ops or not r.hops:
        return None
    return sum(e - s for name, s, e in ops if LAYOUT.search(name)) * 1e-3 / r.hops
