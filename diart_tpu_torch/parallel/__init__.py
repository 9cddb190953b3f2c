from .engine import MultiStreamEngine, StepOutput, StreamState

__all__ = ["MultiStreamEngine", "StepOutput", "StreamState"]
