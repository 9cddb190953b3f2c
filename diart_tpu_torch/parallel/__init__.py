from .cohort import CohortScheduler, HopTiming
from .engine import MultiStreamEngine, StepOutput, StreamState
from .session import MultiStreamSession

__all__ = [
    "CohortScheduler",
    "HopTiming",
    "MultiStreamEngine",
    "MultiStreamSession",
    "StepOutput",
    "StreamState",
]
