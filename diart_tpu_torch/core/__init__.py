from .segment import Segment, SlidingWindow

__all__ = ["Segment", "SlidingWindow"]
