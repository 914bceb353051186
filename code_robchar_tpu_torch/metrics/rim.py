"""RIM / Wasserstein robustness metrics as batched trailing-axis reductions
(counterpart of code_robchar_tpu/metrics/rim.py).

For a sample of fidelities F in [0, 1] along the last axis:

- ``wd_from_ideal`` = W1(F, delta(x-1)) == RIM_1, in the reference's
  sorted-CDF form (wd_sortof_fast_implementation.py:104-116);
- ``wd_from_ideal_zero`` = W1(F, delta(x-0)) = 1 - wd_from_ideal;
- ``rim_p`` = (mean((1-F)^p))^(1/p), with p == 0 giving 1;
- ``compute_dkw_error`` / ``dkw_ecdf_bounds``: the Dvoretzky-Kiefer-
  Wolfowitz confidence band.

All are pure: the caller's tensor is never sorted in place.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _atleast_1d(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.reshape(1) if x.dim() == 0 else x


def wd_from_ideal(fids) -> torch.Tensor:
    """W1 distance of the trailing-axis sample from delta(x-1) (== RIM_1)."""
    fids = _atleast_1d(fids)
    b = fids.shape[-1]
    srt = torch.sort(fids, dim=-1).values
    upper = torch.cat([srt, torch.ones_like(srt[..., :1])], dim=-1)
    intervals = torch.diff(upper, dim=-1)
    cdf = torch.arange(1, b + 1, dtype=srt.dtype, device=srt.device) / b
    return torch.sum(intervals * cdf, dim=-1)


def wd_from_ideal_zero(fids) -> torch.Tensor:
    """W1 distance of the trailing-axis sample from delta(x-0)."""
    return 1.0 - wd_from_ideal(fids)


def rim_p(fids, p: float = 2) -> torch.Tensor:
    """p-order robustness infidelity measure; rim_p(F, 1) ==
    wd_from_ideal(F).  The p == 0 convention returns 1."""
    fids = _atleast_1d(fids)
    if p == 0:
        return torch.ones(fids.shape[:-1], dtype=fids.dtype,
                          device=fids.device)
    out = torch.mean(torch.pow(1.0 - fids, p), dim=-1)
    return torch.pow(out, 1.0 / p)


def compute_dkw_error(alpha: float, nobs: int) -> float:
    """DKW band half-width sqrt(log(2/alpha) / (2 n))."""
    return math.sqrt(math.log(2.0 / alpha) / (2.0 * nobs))


def dkw_ecdf_bounds(cdf, conf_level: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) DKW confidence band around an ECDF, clipped to [0, 1]
    (the band width uses the trailing-axis length)."""
    cdf = _atleast_1d(cdf)
    eps = compute_dkw_error(1.0 - conf_level, cdf.shape[-1])
    return (torch.clamp(cdf - eps, 0.0, 1.0),
            torch.clamp(cdf + eps, 0.0, 1.0))
