"""Sobol quasi-MC restart streams.

A copy of code_robchar_tpu/ops/sobol.py: framework-free host
code, which the port cannot import from the JAX package (importing any
of it pulls in jax).

The reference draws restart points one at a time from an unscrambled
scipy Sobol sequence under landscape exploration (qnewton.py:474, 483-489;
nmplus.py:207).  Init-point generation is not a hot path (SURVEY.md §2.3),
so this stays host-side on scipy, wrapped as a stateful stream that hands
out the next k points of the same sequence the reference consumes.
"""

from __future__ import annotations

import numpy as np


class SobolStream:
    def __init__(self, dim: int, scramble: bool = False, seed=None):
        from scipy.stats import qmc
        self._sampler = qmc.Sobol(d=dim, scramble=scramble, seed=seed)
        self.dim = dim

    def next(self, k: int = 1) -> np.ndarray:
        """Next k points in [0, 1)^dim (sequential, like repeated
        sampler.random()[0] in the reference)."""
        return self._sampler.random(k)
