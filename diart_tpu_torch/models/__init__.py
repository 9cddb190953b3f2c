from .base import EmbeddingModel, SegmentationModel
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet
from .fbank import kaldi_log_mel, nemo_log_mel, speechbrain_log_mel
from .powerset import num_powerset_classes, powerset_mapping, to_multilabel
from .resnet import ResNet34
from .segmentation import PyanNet
from .titanet import TitaNet
from .xvect import XVectorFbank

__all__ = [
    "EcapaTDNN",
    "EmbeddingModel",
    "PyanNet",
    "ResNet34",
    "SegmentationModel",
    "TitaNet",
    "XVectorFbank",
    "XVectorSincNet",
    "kaldi_log_mel",
    "nemo_log_mel",
    "num_powerset_classes",
    "powerset_mapping",
    "speechbrain_log_mel",
    "to_multilabel",
]
