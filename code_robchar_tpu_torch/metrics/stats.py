"""The statistical test kit, the quantile-yield metric and the registry
of the five MC metrics (counterpart of code_robchar_tpu/metrics/stats.py).

The host-side helpers (``get_cdf``, ``get_supcdf``, ``vn_test``,
``get_ranks``, ``clustered_ranks``) are numpy only and copied from the JAX
package (mcsim.py:42-123, 513-518 and
generate_fig4_kendallrankanalysis.py:146-164 of the reference program).

The registry maps the reference's display names — the literal JSON keys
of the .mcm cache schema (mcsim.py:178-183) — to batched trailing-axis
reductions.  All five are "smaller is better" (Q and worst case are
negated, mcsim.py:148-157).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from code_robchar_tpu_torch.metrics.rim import _atleast_1d, wd_from_ideal


def get_cdf(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sum-normalised cumulative distribution (mcsim.py:42-47).

    Note this normalises by the *sum* (so it is a Lorenz-style curve, not an
    ECDF) — faithfully mirrored because figure code depends on it.
    Returns (cdf, sorted_values).
    """
    s = np.sort(np.asarray(arr))
    return s.cumsum() / s.sum(), s


def get_supcdf(cdf: np.ndarray) -> np.ndarray:
    """Suffix-mean transform of a cdf vector (mcsim.py:50-57)."""
    cdf = np.asarray(cdf)
    n = len(cdf)
    # supq_i = mean(cdf[i:]): suffix sums via reversed cumsum.
    suffix = np.cumsum(cdf[::-1])[::-1]
    return suffix / (n - np.arange(n))


def vn_test(obs: np.ndarray, alpha: float = 0.95, bartels: bool = True,
            verbose: bool = False) -> Tuple[bool, float]:
    """Von Neumann successive-difference randomness test (mcsim.py:59-123).

    ``bartels=True`` uses the reference's rank-free variant with the
    grid-searched acceptance threshold 1.1 on the raw VN ratio; otherwise a
    Gaussian-approximation p-value interval.  Host-side (analysis path).
    """
    obs = np.asarray(obs, dtype=float)
    n = obs.size
    if n < 40:
        raise ValueError(f"{n} observations are insufficient for the test")
    sdiff = np.diff(obs)
    vn = float(np.mean(sdiff * sdiff) / obs.var())
    if bartels:
        if verbose:
            print(vn)
        return vn > 1.1, vn
    from scipy.stats import norm
    mean = 2.0 * n / (n - 1)
    sigma = 4.0 * n * n * (n - 2) / ((n + 1) * (n - 1) ** 3)
    phi = float(norm.ppf(1 - alpha, loc=mean, scale=np.sqrt(sigma)))
    if verbose:
        print("sigma", sigma, "mean", mean, "VN", vn, "thresh", phi)
    return vn > phi, phi


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


def get_ranks(array: np.ndarray) -> np.ndarray:
    """Dense ranks, 0 = smallest (mcsim.py:513-518)."""
    array = np.asarray(array)
    argranks = np.argsort(array)
    ranks = np.zeros_like(argranks)
    ranks[argranks] = np.arange(len(argranks))
    return ranks


def clustered_ranks(values: np.ndarray, radius_frac: float) -> np.ndarray:
    """'Little-r' clustered rank assignment
    (generate_fig4_kendallrankanalysis.py:146-164): values within
    ``radius_frac * (max - min)`` of the current cluster seed share a rank.
    """
    values = np.asarray(values, dtype=float)
    order = np.argsort(values)
    srt = values[order]
    radius = radius_frac * (srt[-1] - srt[0]) if len(srt) > 1 else 0.0
    ranks_sorted = np.zeros(len(srt), dtype=int)
    rank = 0
    seed = srt[0] if len(srt) else 0.0
    for i in range(1, len(srt)):
        if srt[i] - seed > radius:
            rank += 1
            seed = srt[i]
        ranks_sorted[i] = rank
    ranks = np.zeros(len(srt), dtype=int)
    ranks[order] = ranks_sorted
    return ranks
