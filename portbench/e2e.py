"""The end-to-end metrics, from what the host clock recorded in the window.

* ``streams_per_card``: B x step x (hops harvested with text for every
  stream in the window) / window seconds: the real-time streams the card
  serves, a rate over the whole window.
* ``reply_p50_ms``: the median, over every hop of every cohort in the
  window, of ``done - due``: from when a cohort's block was due to when its
  RTTM text was ready. It is what a hop that waits behind no stall takes
  (the dispatch, the step on the card, the harvest), and moves with each.

``reply_p95_ms``, the same reply at the 95th percentile, is a per-layer
metric of the traced window (``metrics/reply_p95_ms.realtime.py``): at 4/5
of the knee only some 5% of hops queue behind a stall of the host, so it
swings with the host's stalls from run to run.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def streams_per_card(batch: int, step_s: float, hops: int, window_s: float) -> float:
    return batch * step_s * hops / window_s


def reply_ms(timings: Sequence) -> np.ndarray:
    return np.asarray([(t.done - t.due) * 1e3 for t in timings], np.float64)


def reply_p50_ms(timings: Sequence) -> float:
    return float(np.percentile(reply_ms(timings), 50))


def reply_p95_ms(timings: Sequence) -> float:
    return float(np.percentile(reply_ms(timings), 95))


def late_hops(timings: Sequence, limit_s: float) -> int:
    """Hops whose reply came later than one step period."""
    return int((reply_ms(timings) > limit_s * 1e3).sum())
