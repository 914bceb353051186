"""The quantile-yield metric and the registry of the five MC metrics
(counterpart of the device-side part of code_robchar_tpu/metrics/stats.py).

The registry maps the reference's display names — the literal JSON keys
of the .mcm cache schema (mcsim.py:178-183) — to batched trailing-axis
reductions.  All five are "smaller is better" (Q and worst case are
negated, mcsim.py:148-157).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from code_robchar_tpu_torch.metrics.rim import _atleast_1d, wd_from_ideal


def quantile_yield(fids, threshold: float) -> torch.Tensor:
    """Q(F, th) = fraction of samples with fidelity >= th, batched over
    leading axes."""
    fids = _atleast_1d(fids)
    return torch.mean((fids >= threshold).to(fids.dtype), dim=-1)


def _neg_q(th: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def metric(fids: torch.Tensor) -> torch.Tensor:
        return -quantile_yield(fids, th)
    return metric


def _std(fids) -> torch.Tensor:
    # population std, as jnp.std (torch.std defaults to the unbiased one)
    return torch.std(_atleast_1d(fids), dim=-1, correction=0)


def _worst_case(fids) -> torch.Tensor:
    return -torch.amin(_atleast_1d(fids), dim=-1)


metric_registry: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    r"$W(.,\delta(x-1))$": wd_from_ideal,
    "Q th. 0.95": _neg_q(0.95),
    "Q th. 0.98": _neg_q(0.98),
    "std": _std,
    "worst case fid": _worst_case,
}
