"""diart_tpu_torch: the PyTorch/CUDA port of diart_tpu's streaming engine.

The multi-stream diarization step (PyanNet segmentation, XVectorSincNet
embedding, masked online clustering, Hamming overlap-add) runs on an NVIDIA
GPU, with the two kernels of that path written by hand for Hopper
(``csrc/lstm_sweep.cu``, ``csrc/linear_stats.cu``). The package imports
torch, numpy and scipy only — never jax or ``diart_tpu``.

Entry points default to ``device="cuda"`` and raise without a GPU; pass
``device="cpu"`` to run every kernel's plain PyTorch version instead.
"""

from .models import EmbeddingModel, SegmentationModel
from .parallel import MultiStreamEngine, StepOutput, StreamState

__all__ = [
    "EmbeddingModel",
    "MultiStreamEngine",
    "SegmentationModel",
    "StepOutput",
    "StreamState",
]
