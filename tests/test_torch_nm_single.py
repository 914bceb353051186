"""The port's single-stream Nelder-Mead (models/nmplus.py ``_nm_while``,
``NMPlus.run_accelerated`` and the in-house variant's helpers) against the
JAX package, on the CPU at float64.

- ``_nm_while`` on tests/test_models.py's synthetic objective in its three
  runs (plain, every iteration stagnant so the restarts fire, an
  impossible threshold that never restarts): x within 1e-12, nfev and nit
  equal.
- ``_nm_while`` on the real single-point objective at N=4 from a regular
  simplex with stagnation restarts, noiseless, ham_noisy and fid_noisy:
  x and f within 1e-10, nfev and nit equal.  Every iteration draws its
  4 + (d+1) keys as the reference does, so the noisy runs agree only if
  the draws do.
- A whole ``run_accelerated(300)`` equal to JAX's.
- ``powell``, ``f``, ``sort_simplex`` and ``estimate_hyperplane``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.models import NMPlus as JNMPlus
from code_robchar_tpu.models import nmplus as jnm, objectives as jobj
from code_robchar_tpu_torch.models import NMPlus, nmplus, objectives
from code_robchar_tpu_torch.ops import prng

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


@pytest.mark.parametrize("kw", [
    dict(stagnation_restart=False),
    dict(stagnation_restart=True, improv_thres=1e30),
    dict(stagnation_restart=True, improv_thres=0.0)],
    ids=["plain", "restarts", "impossible_threshold"])
def test_nm_while_matches_jax_on_the_synthetic_objective(kw):
    d = 3
    lower, upper = np.full(d, -1.0), np.full(d, 1.0)

    def jinfid(x, key):
        return jnp.asarray(1.0) + 1e-3 * jnp.sum(x * x), jnp.int32(1)

    def infid(xs, keys):
        return 1.0 + 1e-3 * (xs * xs).sum(-1), torch.ones(
            xs.shape[:-1], dtype=torch.int32)

    simplex0 = np.random.default_rng(0).uniform(-1, 1, (d + 1, d))
    wx, wf, wn, wit = jnm._nm_while(
        jnp.asarray(simplex0), jax.random.key(0), jinfid, jnp.asarray(lower),
        jnp.asarray(upper), maxfev=400, fatol=0.0, xatol=0.0, **kw)
    gx, gf, gn, git, stats = nmplus._nm_while(
        _t(simplex0), prng.key(0), infid, _t(lower), _t(upper), maxfev=400,
        fatol=0.0, xatol=0.0, **kw)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-12)
    assert abs(float(gf) - float(wf)) <= 1e-12
    assert int(gn) == int(wn) and int(git) == int(wit)
    assert stats["syncs"] == stats["iterations"] + 1 == int(git) + 1
    assert stats["launches"] == 1 + stats["iterations"] + stats["restarts"]
    assert (stats["restarts"] > 0) == (kw.get("improv_thres") == 1e30)


@pytest.mark.parametrize("regime", [{}, dict(ham_noisy=True),
                                    dict(fid_noisy=True)],
                         ids=["noiseless", "ham_noisy", "fid_noisy"])
def test_nm_while_matches_jax_on_the_objective(regime):
    n, d = 4, 5
    jopt = JNMPlus(n, 0, n - 1, testing=True, seed=3, **regime)
    opt = NMPlus(n, 0, n - 1, testing=True, seed=3, **F64, **regime)
    x0 = np.random.default_rng(1).uniform(-5, 5, d)
    x0[n] = 4.0
    jk = jax.random.key(9)
    simplex = jnm.regular_simplex(jnp.asarray(x0), jopt._lower, jopt._upper,
                                  jk)
    wx, wf, wn, wit = jnm._nm_while(
        simplex, jk, jobj.make_infidelity(jopt.spec()), jopt._lower,
        jopt._upper, maxfev=240, stagnation_restart=True)
    gx, gf, gn, git, stats = nmplus._nm_while(
        _t(simplex), prng.key(9), objectives.make_infidelity(opt.spec()),
        opt._lower, opt._upper, maxfev=240, stagnation_restart=True)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-10)
    assert abs(float(gf) - float(wf)) <= 1e-10
    assert int(gn) == int(wn) and int(git) == int(wit)
    assert int(git) > 10 and stats["syncs"] == int(git) + 1


def test_run_accelerated_matches_jax():
    jopt = JNMPlus(4, 0, 3, testing=True, seed=5)
    opt = NMPlus(4, 0, 3, testing=True, seed=5, **F64)
    wf, wx = jopt.run_accelerated(300)
    gf, gx = opt.run_accelerated(300)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-10)
    assert abs(gf - wf) <= 1e-10
    # one launch an iteration, one more a restart and the first simplex
    st = opt.stats
    assert st["launches"] == 1 + st["iterations"] + st["restarts"]
    assert st["restarts"] >= 1 and st["syncs"] == st["iterations"] + 1
    # the keys advanced as the reference's: the next draw is the same
    np.testing.assert_array_equal(
        prng.key_from_data(np.asarray(jax.random.key_data(
            jopt.next_key()))).numpy(), opt.next_key().numpy())


def test_benchmark_objectives_and_simplex_helpers():
    rng = np.random.default_rng(4)
    for x in rng.normal(0, 2, (5, 6)):
        assert NMPlus.powell(x) == JNMPlus.powell(x)
        assert NMPlus.f(x) == JNMPlus.f(x)
    jopt = JNMPlus(4, 0, 3, testing=True, seed=2, ham_noisy=True)
    opt = NMPlus(4, 0, 3, testing=True, seed=2, ham_noisy=True, **F64)
    simplex = rng.uniform(-3, 3, (6, 5))
    simplex[:, 4] = np.abs(simplex[:, 4])
    ws, wv = jopt.sort_simplex(simplex)
    gs, gv = opt.sort_simplex(simplex)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-10)
    assert gv == sorted(gv)
    ws2, wv2 = jopt.sort_simplex(simplex, obj_f=JNMPlus.powell)
    gs2, gv2 = opt.sort_simplex(simplex, obj_f=NMPlus.powell)
    np.testing.assert_array_equal(gs2, ws2)
    assert gv2 == wv2
    np.testing.assert_allclose(opt.estimate_hyperplane(gs, gv),
                               jopt.estimate_hyperplane(gs, gv), rtol=0,
                               atol=1e-10)
    # the host objective: one ham-noisy evaluation a call, as the reference
    x = simplex[0]
    assert abs(opt.infidelity(x) - jopt.infidelity(x)) <= 1e-10
