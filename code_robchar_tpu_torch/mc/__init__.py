"""The Monte-Carlo robustness engine."""

from code_robchar_tpu_torch.mc.engine import (
    mc_fidelity_sweep,
    mc_metric_sweep,
    metric_tensors,
    arim_from_rims,
    characterise,
    bootstrap_statistic_std,
)

__all__ = [
    "mc_fidelity_sweep",
    "mc_metric_sweep",
    "metric_tensors",
    "arim_from_rims",
    "characterise",
    "bootstrap_statistic_std",
]
