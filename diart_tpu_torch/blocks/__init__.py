"""diart's public pipeline API on the port (port of ``diart_tpu/blocks``):
the two pipelines, their configs and every block they are built from."""

from .base import (
    DeltaNew,
    HyperParameter,
    Pipeline,
    PipelineConfig,
    RhoUpdate,
    TauActive,
)
from .aggregation import (
    AggregationStrategy,
    AverageStrategy,
    DelayedAggregation,
    FirstOnlyStrategy,
    HammingWeightedAverageStrategy,
)
from .clustering import OnlineSpeakerClustering
from .diarization import SpeakerDiarization, SpeakerDiarizationConfig
from .embedding import (
    EmbeddingNormalization,
    OverlapAwareSpeakerEmbedding,
    OverlappedSpeechPenalty,
    SpeakerEmbedding,
)
from .mapping import SpeakerMap, SpeakerMapBuilder
from .segmentation import SpeakerSegmentation
from .utils import AdjustVolume, Binarize, Resample
from .vad import VoiceActivityDetection, VoiceActivityDetectionConfig

__all__ = [
    "HyperParameter",
    "TauActive",
    "RhoUpdate",
    "DeltaNew",
    "Pipeline",
    "PipelineConfig",
    "AggregationStrategy",
    "HammingWeightedAverageStrategy",
    "AverageStrategy",
    "FirstOnlyStrategy",
    "DelayedAggregation",
    "OnlineSpeakerClustering",
    "SpeakerDiarization",
    "SpeakerDiarizationConfig",
    "SpeakerEmbedding",
    "OverlappedSpeechPenalty",
    "EmbeddingNormalization",
    "OverlapAwareSpeakerEmbedding",
    "SpeakerMap",
    "SpeakerMapBuilder",
    "SpeakerSegmentation",
    "Binarize",
    "Resample",
    "AdjustVolume",
    "VoiceActivityDetection",
    "VoiceActivityDetectionConfig",
]
