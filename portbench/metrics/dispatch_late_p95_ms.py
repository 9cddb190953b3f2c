"""How late the open-loop generator dispatched its hops: the 95th percentile
of ``dispatched - due`` over every hop of every cohort in the window
(``HopTiming``), in milliseconds."""

import numpy as np


def read(r):
    if not r.timings:
        return None
    return float(np.percentile([(t.dispatched - t.due) * 1e3 for t in r.timings], 95))
