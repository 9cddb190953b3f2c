from .base import EmbeddingModel, SegmentationModel
from .embedding import XVectorSincNet
from .segmentation import PyanNet

__all__ = ["EmbeddingModel", "PyanNet", "SegmentationModel", "XVectorSincNet"]
