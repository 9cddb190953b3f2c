"""diart_tpu_torch: the PyTorch/CUDA port of diart_tpu's streaming engine
and its serving path.

The multi-stream diarization step (PyanNet segmentation, multilabel or
powerset; an x-vector, ECAPA-TDNN, TitaNet, speechbrain fbank x-vector or
ResNet34 embedding; masked online clustering; Hamming overlap-add) runs
on an NVIDIA GPU, with the four kernels of its paths written by hand for
Hopper (``csrc/lstm_sweep.cu``, ``csrc/linear_stats.cu``,
``csrc/attn_stats.cu``, ``csrc/se_res2.cu``). :class:`MultiStreamSession`
turns each hop's output into annotations or RTTM text per stream (scores
thresholded and bit-packed on the device, turns assembled by the native
``native/rttm.cpp``), and :class:`CohortScheduler` serves K sessions from
one engine at staggered phases. diart's pipeline API (``blocks``:
:class:`SpeakerDiarization`, :class:`VoiceActivityDetection` and their
blocks) runs one stream's chunks in batches through the same models and
kernels. The package imports torch, numpy and scipy only — never jax or
``diart_tpu`` (pandas only for a metric's ``report()``).

Entry points default to ``device="cuda"`` and raise without a GPU; pass
``device="cpu"`` to run every kernel's plain PyTorch version instead.
:class:`Precision` is the numerics policy (``precision.py``; the
``DIART_TPU_*`` variables of its switches override it, as in the JAX
package).
"""

from .blocks import (
    SpeakerDiarization,
    SpeakerDiarizationConfig,
    VoiceActivityDetection,
    VoiceActivityDetectionConfig,
)
from .models import EmbeddingModel, SegmentationModel
from .parallel import (
    CohortScheduler,
    HopTiming,
    MultiStreamEngine,
    MultiStreamSession,
    StepOutput,
    StreamState,
)
from .precision import Precision

__all__ = [
    "CohortScheduler",
    "EmbeddingModel",
    "HopTiming",
    "MultiStreamEngine",
    "MultiStreamSession",
    "Precision",
    "SegmentationModel",
    "SpeakerDiarization",
    "SpeakerDiarizationConfig",
    "StepOutput",
    "StreamState",
    "VoiceActivityDetection",
    "VoiceActivityDetectionConfig",
]
