from .base import EmbeddingModel, SegmentationModel
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet
from .segmentation import PyanNet

__all__ = ["EcapaTDNN", "EmbeddingModel", "PyanNet", "SegmentationModel", "XVectorSincNet"]
