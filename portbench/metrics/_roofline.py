"""Shared arithmetic of the roofline readers (a helper, not a metric)."""

import re

from portbench.work import kernel_bound_s


def share(r, which):
    """100 x the chosen kernels' least seconds over the window's hops, over
    the device seconds of the operations their patterns name; None when the
    trace holds none of them."""
    chosen = [k for k in r.kernels if which(k)]
    if not chosen:
        return None
    pattern = re.compile("|".join(f"(?:{k['pattern']})" for k in chosen))
    lo, hi = r.window
    device_us = sum(e - s for name, s, e in r.device if lo <= s < hi and pattern.search(name))
    if device_us <= 0:
        return None
    return 100.0 * sum(kernel_bound_s(k) for k in chosen) * r.hops / (device_us * 1e-6)
