from .cohort import CohortScheduler, HopTiming
from .engine import MultiStreamEngine, Sharded, StepOutput, StreamState
from .mesh import StreamsMesh, initialize_distributed, provision_devices, streams_mesh
from .session import MultiStreamSession

__all__ = [
    "CohortScheduler",
    "HopTiming",
    "MultiStreamEngine",
    "MultiStreamSession",
    "Sharded",
    "StepOutput",
    "StreamState",
    "StreamsMesh",
    "initialize_distributed",
    "provision_devices",
    "streams_mesh",
]
