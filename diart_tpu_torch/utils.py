"""Host utilities of the port: the wall-clock ``Chronometer`` (a copy of
``diart_tpu/utils.py``'s, as diart's ``utils.Chronometer``)."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

__all__ = ["Chronometer"]


class Chronometer:
    """Wall-clock profiler for per-unit latencies (mean ± std report)."""

    def __init__(self, unit: str, progress_bar=None):
        self.unit = unit
        self.progress_bar = progress_bar
        self.current_start_time: Optional[float] = None
        self.history = []

    @property
    def is_running(self) -> bool:
        return self.current_start_time is not None

    def start(self):
        self.current_start_time = time.monotonic()

    def stop(self, do_count: bool = True):
        assert self.current_start_time is not None, "stop() called before start()"
        elapsed = time.monotonic() - self.current_start_time
        self.current_start_time = None
        if do_count:
            self.history.append(elapsed)

    def report(self):
        if not self.history:
            return
        print_fn = print if self.progress_bar is None else self.progress_bar.write
        print_fn(
            f"Took {np.mean(self.history):.3f} "
            f"(+/-{np.std(self.history):.3f}) seconds/{self.unit} "
            f"-- ran {len(self.history)} times"
        )
