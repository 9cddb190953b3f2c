from .der import BaseMetric, DetectionErrorRate, DiarizationErrorRate

__all__ = ["BaseMetric", "DiarizationErrorRate", "DetectionErrorRate"]
