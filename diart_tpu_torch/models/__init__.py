from .base import EmbeddingModel, LazyModel, SegmentationModel
from .common import resample_weights
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet, weighted_stats_pool
from .fbank import (
    kaldi_log_mel,
    log_mel_filterbank,
    mel_filter_matrix,
    nemo_log_mel,
    num_fbank_frames,
    speechbrain_log_mel,
)
from .lstm import BiLSTM
from .powerset import num_powerset_classes, powerset_mapping, to_multilabel
from .resnet import ResNet34
from .segmentation import PyanNet
from .sincnet import SincConv, SincNet, num_sincnet_frames
from .titanet import TitaNet
from .xvect import XVectorFbank

__all__ = [
    "BiLSTM",
    "EcapaTDNN",
    "EmbeddingModel",
    "LazyModel",
    "PyanNet",
    "ResNet34",
    "SegmentationModel",
    "SincConv",
    "SincNet",
    "TitaNet",
    "XVectorFbank",
    "XVectorSincNet",
    "kaldi_log_mel",
    "log_mel_filterbank",
    "mel_filter_matrix",
    "nemo_log_mel",
    "num_fbank_frames",
    "num_powerset_classes",
    "num_sincnet_frames",
    "powerset_mapping",
    "resample_weights",
    "speechbrain_log_mel",
    "to_multilabel",
    "weighted_stats_pool",
]
