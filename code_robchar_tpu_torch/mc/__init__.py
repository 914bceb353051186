"""The cachable Monte-Carlo robustness engine."""

from code_robchar_tpu_torch.mc.engine import (
    mc_fidelity_sweep,
    mc_metric_sweep,
    metric_tensors,
    arim_from_rims,
    characterise,
    bootstrap_statistic_std,
)
from code_robchar_tpu_torch.mc.datasim import MCDataSim, remove_redundant_ticks

__all__ = [
    "mc_fidelity_sweep",
    "mc_metric_sweep",
    "metric_tensors",
    "arim_from_rims",
    "characterise",
    "bootstrap_statistic_std",
    "MCDataSim",
    "remove_redundant_ticks",
]
