from .linear_stats import fused_linear_stats, linear_stats_reference
from .lstm_sweep import lstm_sweep_reference, lstm_sweep_tm

__all__ = [
    "fused_linear_stats",
    "linear_stats_reference",
    "lstm_sweep_reference",
    "lstm_sweep_tm",
]
