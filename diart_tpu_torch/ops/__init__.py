from .attn_stats import attentive_stats_reference, fused_attentive_stats
from .linear_stats import fused_linear_stats, linear_stats_reference
from .lstm_sweep import SweepWeights, lstm_sweep_reference, lstm_sweep_tm, pack_w_hh
from .se_res2 import (
    Res2Operands,
    fused_se_res2_block,
    kernel_operands,
    se_res2_block_reference,
    se_res2_stage_reference,
    se_res2_staged,
)

__all__ = [
    "Res2Operands",
    "SweepWeights",
    "attentive_stats_reference",
    "fused_attentive_stats",
    "fused_linear_stats",
    "fused_se_res2_block",
    "kernel_operands",
    "linear_stats_reference",
    "lstm_sweep_reference",
    "lstm_sweep_tm",
    "pack_w_hh",
    "se_res2_block_reference",
    "se_res2_stage_reference",
    "se_res2_staged",
]
