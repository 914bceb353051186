"""The port's metrics (code_robchar_tpu_torch/metrics, mc/engine
metric_tensors and arim_from_rims) against the JAX package on the same
numpy fidelities at f64 (1e-12)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu.metrics import rim as jrim
from code_robchar_tpu.metrics import stats as jstats
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.metrics import rim, stats

TOL = 1e-12


@pytest.fixture
def fids(rng):
    f = rng.uniform(0.6, 1.0, (3, 4, 16))
    f[0, 0, :4] = 0.95          # on a Q threshold
    f[0, 1, :] = 1.0            # an ideal cell
    f[1, 2, ::2] = 0.98
    return f


def _close(got, want):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), rtol=0, atol=TOL)


def test_metric_tensors_match_jax(fids):
    want = jengine.metric_tensors(jnp.asarray(fids), 0.05)
    got = engine.metric_tensors(torch.as_tensor(fids), 0.05)
    assert set(got) == set(want) and len(got) == 15
    for k in want:
        assert got[k].shape == (3, 4), k
        _close(got[k], want[k])


def test_registry_names_match_the_mcm_schema():
    assert list(stats.metric_registry) == list(jstats.metric_registry)


@pytest.mark.parametrize("name", list(jstats.metric_registry))
def test_registry_metrics_match_jax(fids, name):
    _close(stats.metric_registry[name](torch.as_tensor(fids)),
           jstats.metric_registry[name](jnp.asarray(fids)))


def test_std_is_the_population_std(fids):
    """jnp.std is the population std; torch.std defaults to the unbiased
    one, which at B = 16 is larger by sqrt(16/15) (~3%)."""
    want = np.asarray(jstats._std(jnp.asarray(fids)))
    got = stats._std(torch.as_tensor(fids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    unbiased = torch.std(torch.as_tensor(fids), dim=-1).numpy()
    assert np.abs(unbiased - want).max() > 1e-3


def test_rim_functions_match_jax(fids):
    t = torch.as_tensor(fids)
    _close(rim.wd_from_ideal(t), jrim.wd_from_ideal(jnp.asarray(fids)))
    _close(rim.wd_from_ideal_zero(t),
           jrim.wd_from_ideal_zero(jnp.asarray(fids)))
    for p in (0, 1, 2, 3.5):
        _close(rim.rim_p(t, p), jrim.rim_p(jnp.asarray(fids), p))
    # rim_p(F, 1) == wd_from_ideal(F)
    _close(rim.rim_p(t, 1), rim.wd_from_ideal(t))
    for th in (0.95, 0.98):
        _close(stats.quantile_yield(t, th),
               jstats.quantile_yield(jnp.asarray(fids), th))
    # scalars and 1-d samples
    _close(rim.wd_from_ideal(np.float64(0.9)), jrim.wd_from_ideal(0.9))
    _close(stats.quantile_yield(t[0, 0], 0.95),
           jstats.quantile_yield(jnp.asarray(fids[0, 0]), 0.95))


def test_dkw_matches_jax(fids):
    for alpha, nobs in ((0.05, 16), (0.01, 100)):
        assert abs(rim.compute_dkw_error(alpha, nobs)
                   - float(jrim.compute_dkw_error(alpha, nobs))) < TOL
    cdf = np.sort(fids[0, 0]) / fids[0, 0].max()
    lo, hi = rim.dkw_ecdf_bounds(torch.as_tensor(cdf), 0.95)
    jlo, jhi = jrim.dkw_ecdf_bounds(jnp.asarray(cdf), 0.95)
    _close(lo, jlo)
    _close(hi, jhi)


def test_arim_from_rims_matches_jax(rng):
    rims = rng.uniform(-0.05, 0.4, (11, 30))     # clipping engages
    _close(engine.arim_from_rims(torch.as_tensor(rims)),
           jengine.arim_from_rims(jnp.asarray(rims)))
