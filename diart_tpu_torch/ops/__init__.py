"""The port's operations: the hand-written kernels' wrappers (each with its
plain version and its ``autograd.Function``) and, as the JAX package's
``diart_tpu.ops`` exports them, the streaming step's building blocks
(clustering, aggregation, assignment, binarization, resampling).
``binarize`` is both the module ``ops/binarize.py`` and, called, its
:func:`~.binarize.binarize`."""

from . import binarize
from .aggregation import AggregationGeometry, aggregate, build_geometry
from .assignment import assign_rows, assign_rows_host
from .attn_stats import AttnStatsFunction, attentive_stats_reference, fused_attentive_stats
from .clustering import ClusteringParams, ClusteringState, cluster_step, init_state
from .functional import cosine_cdist, min_max_normalize, normalize_embeddings, overlapped_speech_penalty
from .linear_stats import LinearStatsFunction, fused_linear_stats, linear_stats_reference
from .lstm_sweep import SweepFunction, SweepWeights, lstm_sweep_reference, lstm_sweep_tm, pack_w_hh
from .quant import Int8ConvFunction, int8_conv, quantize_per_sample, quantize_weight
from .resample import resample
from .se_res2 import (
    Res2Operands,
    SERes2Function,
    fused_se_res2_block,
    kernel_operands,
    se_res2_block_reference,
    se_res2_stage_reference,
    se_res2_staged,
)
from .sinc_frontend import SincFrontendFunction, SincOperands, prepare_sinc_operands, sinc_frontend_reference

__all__ = [
    "AggregationGeometry",
    "AttnStatsFunction",
    "ClusteringParams",
    "ClusteringState",
    "Int8ConvFunction",
    "LinearStatsFunction",
    "Res2Operands",
    "SERes2Function",
    "SincFrontendFunction",
    "SincOperands",
    "SweepFunction",
    "SweepWeights",
    "aggregate",
    "assign_rows",
    "assign_rows_host",
    "attentive_stats_reference",
    "binarize",
    "build_geometry",
    "cluster_step",
    "cosine_cdist",
    "fused_attentive_stats",
    "fused_linear_stats",
    "fused_se_res2_block",
    "init_state",
    "int8_conv",
    "kernel_operands",
    "linear_stats_reference",
    "lstm_sweep_reference",
    "lstm_sweep_tm",
    "min_max_normalize",
    "normalize_embeddings",
    "overlapped_speech_penalty",
    "pack_w_hh",
    "prepare_sinc_operands",
    "quantize_per_sample",
    "quantize_weight",
    "resample",
    "se_res2_block_reference",
    "se_res2_stage_reference",
    "se_res2_staged",
    "sinc_frontend_reference",
]
