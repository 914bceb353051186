"""Robustness metrics: RIM / Wasserstein reductions, DKW bands, the
metric registry, the statistical test kit."""

from code_robchar_tpu_torch.metrics.rim import (
    wd_from_ideal,
    wd_from_ideal_zero,
    rim_p,
    compute_dkw_error,
    dkw_ecdf_bounds,
)
from code_robchar_tpu_torch.metrics.stats import (
    get_cdf,
    get_supcdf,
    vn_test,
    quantile_yield,
    metric_registry,
    get_ranks,
    clustered_ranks,
)

# Reference-compatible aliases (wd_sortof_fast_implementation.py exports).
RIM_p = rim_p
Q = quantile_yield

__all__ = [
    "wd_from_ideal",
    "wd_from_ideal_zero",
    "rim_p",
    "RIM_p",
    "compute_dkw_error",
    "dkw_ecdf_bounds",
    "get_cdf",
    "get_supcdf",
    "vn_test",
    "quantile_yield",
    "Q",
    "metric_registry",
    "get_ranks",
    "clustered_ranks",
]
