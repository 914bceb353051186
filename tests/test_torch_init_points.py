"""Start points of the optimizer zoo in float32: the port's
``ControlOptimizer.init_points`` against the JAX package's float32
arithmetic, bit for bit.

The JAX optimizer computes ``lo + (hi - lo) * u`` with its bounds as jnp
arrays, float32 when x64 is off, on the float32 words of
``jax.random.uniform`` (uniform starts) or on float64 Sobol points, which
promote the product to float64 (landscape exploration).  This suite runs
with x64 on (tests/conftest.py), so the reference's float32 arithmetic is
written out here in numpy float32 on the same uniform words, drawn from
the JAX optimizer's own key sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_robchar_tpu.models import LBFGS as JLBFGS, NMPlus as JNMPlus
from code_robchar_tpu.ops import sobol as jsobol
from code_robchar_tpu_torch.models import LBFGS, NMPlus


def _bounds32(jopt):
    lo = np.asarray([b[0] for b in jopt.val_bounds], dtype=np.float32)
    hi = np.asarray([b[1] for b in jopt.val_bounds], dtype=np.float32)
    return lo, hi


@pytest.mark.parametrize("pair,n,seed,k", [
    ((JLBFGS, LBFGS), 4, 3, 64),
    ((JLBFGS, LBFGS), 7, 11, 256),
    ((JNMPlus, NMPlus), 5, 7, 100),
], ids=["lbfgs_n4", "lbfgs_n7", "nm_n5"])
def test_uniform_starts_are_the_references_float32_arithmetic(pair, n, seed,
                                                              k):
    jcls, cls = pair
    jopt = jcls(n, 0, n - 1, testing=True, seed=seed)
    opt = cls(n, 0, n - 1, testing=True, seed=seed, device="cpu",
              dtype=torch.float32)
    lo, hi = _bounds32(jopt)
    for _ in range(2):                       # two draws of the key stream
        u = np.asarray(jax.random.uniform(jopt.next_key(), (k, n + 1),
                                          dtype=jnp.float32))
        want = lo + (hi - lo) * u
        got = opt.init_points(k)
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_uniform_starts_in_float64_stay_the_references_x64_ones():
    """Under float64 (the parity regime) the starts are the JAX package's
    x64 starts, as before."""
    jopt = JLBFGS(4, 0, 2, testing=True, seed=3)
    opt = LBFGS(4, 0, 2, testing=True, seed=3, device="cpu",
                dtype=torch.float64)
    got = opt.init_points(32)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jopt.init_points(32))


@pytest.mark.parametrize("n,k", [(4, 64), (7, 200)])
def test_sobol_starts_promote_as_the_reference(n, k):
    """Landscape exploration: float32 bounds times float64 Sobol points, a
    float64 result, as the JAX package computes it without x64."""
    jopt = JLBFGS(n, 0, n - 1, testing=True, seed=1,
                  landscape_exploration=True)
    opt = LBFGS(n, 0, n - 1, testing=True, seed=1, device="cpu",
                dtype=torch.float32, landscape_exploration=True)
    lo, hi = _bounds32(jopt)
    stream = jsobol.SobolStream(n + 1)
    for _ in range(2):
        u = stream.next(k)
        want = lo + (hi - lo) * u
        got = opt.init_points(k)
        assert got.dtype == np.float64 and want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
