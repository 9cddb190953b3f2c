from .annotation import Annotation, Timeline, load_rttm, write_rttm
from .segment import Segment, SlidingWindow, SlidingWindowFeature

__all__ = [
    "Annotation",
    "Segment",
    "SlidingWindow",
    "SlidingWindowFeature",
    "Timeline",
    "load_rttm",
    "write_rttm",
]
