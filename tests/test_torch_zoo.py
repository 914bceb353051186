"""The port's optimizer zoo slice (code_robchar_tpu_torch/models: the
objectives, the base run loop, L-BFGS and Nelder-Mead) against the JAX
package, on the CPU at small sizes.

- The recycled restart loops on the deterministic Rosenbrock function:
  x within 1e-10, nit and nfev equal, and their billing invariance.
- The batched objectives in the noiseless, ham_noisy and fixed-ensemble
  regimes for the same key: 1e-10 at f64, which shows the draws are the
  same numbers.
- ``_run_batch`` of both optimizers on a 64-restart pool at N=4, per
  restart.  Nelder-Mead holds over the whole run.  L-BFGS on the transfer
  landscape amplifies rounding differences: the 1e-14 gap between the two
  frameworks' Jacobi arithmetic grows tenfold about every four
  line-search trials, so whole runs part after some 20 iterations.
  L-BFGS is held per restart over its first three iterations, and over
  whole runs against JAX's own parting when its starts move by 1e-14 (and
  by distribution, the KS gates).
- The host helpers and ``carry_state``.

The KS gates and ``run()`` are in tests/test_torch_zoo_gates.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.models import LBFGS as JLBFGS, NMPlus as JNMPlus
from code_robchar_tpu.models import lbfgs as jlbfgs, nmplus as jnm
from code_robchar_tpu.models import objectives as jobj
from code_robchar_tpu.ops import chain as jchain, noise as jnoise
from code_robchar_tpu_torch.models import LBFGS, NMPlus
from code_robchar_tpu_torch.models import base, lbfgs, nmplus, objectives
from code_robchar_tpu_torch.ops import chain, noise, prng
from code_robchar_tpu_torch.parallel import Mesh

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


def _keys(key, k):
    """(JAX keys, port keys) of split(key, k)."""
    jk = jax.random.split(key, k)
    return jk, prng.key_from_data(np.asarray(jax.random.key_data(jk)))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# ----------------------------------------------------------- Rosenbrock


def _jrosen(xs):
    return jnp.sum(100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 +
                   (1.0 - xs[:, :-1]) ** 2, axis=1)


def _rosen(xs):
    return (100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 +
            (1.0 - xs[:, :-1]) ** 2).sum(1)


def _rosen_grad(xs):
    a, b = xs[:, :-1], xs[:, 1:]
    g = torch.zeros_like(xs)
    g[:, :-1] = -400.0 * a * (b - a ** 2) - 2.0 * (1.0 - a)
    g[:, 1:] += 200.0 * (b - a ** 2)
    return g


@pytest.mark.parametrize("maxfun", [25, 15000])
def test_lbfgs_loop_matches_jax_on_rosenbrock(maxfun):
    """maxfun=25 binds (the objective-call gate); 15000 lets every restart
    converge.  8 lanes recycle over 16 restarts."""
    x0 = np.random.default_rng(7).uniform(-2, 2, (16, 5))
    lo, hi = np.full(5, -5.0), np.full(5, 5.0)

    def jvag(xs, key):
        return (_jrosen(xs),
                jax.vmap(jax.grad(lambda x: _jrosen(x[None])[0]))(xs),
                jnp.full(xs.shape[0], 1, jnp.int32))

    def vag(cost):
        def f(xs, key):
            return _rosen(xs), _rosen_grad(xs), torch.full(
                (xs.shape[0],), cost, dtype=torch.int32)
        return f

    want = jlbfgs._batched_restarts(jnp.asarray(x0), jax.random.key(0), jvag,
                                    jnp.asarray(lo), jnp.asarray(hi), 200,
                                    maxfun, lanes=8)
    got = lbfgs._batched_restarts(_t(x0), prng.key(0), vag(1), _t(lo),
                                  _t(hi), 200, maxfun, lanes=8)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.nit.numpy(), want.nit)
    np.testing.assert_array_equal(got.nfev.numpy(), want.nfev)
    assert got.nit.max() > 3 and got.rounds > 0 and got.syncs > got.rounds
    # billing invariance: the gate counts objective calls, not billing
    g50 = lbfgs._batched_restarts(_t(x0), prng.key(0), vag(50), _t(lo),
                                  _t(hi), 200, maxfun, lanes=8)
    assert torch.equal(g50.x, got.x) and torch.equal(g50.nit, got.nit)
    assert torch.equal(g50.nfev, got.nfev * 50)


def test_nm_loop_matches_jax_on_rosenbrock():
    d = 4
    rng = np.random.default_rng(11)
    lo, hi = np.full(d, -5.0), np.full(d, 5.0)
    x0 = rng.uniform(-2, 2, (12, d))
    jk, tk = _keys(jax.random.key(3), 12)
    want_s = jax.vmap(lambda x, k: jnm.regular_simplex(
        x, jnp.asarray(lo), jnp.asarray(hi), k))(jnp.asarray(x0), jk)
    got_s = torch.stack([nmplus.regular_simplex(_t(x), _t(lo), _t(hi), k)
                         for x, k in zip(x0, tk)])
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-15)

    def jinfid(xs, key):
        return _jrosen(xs), jnp.full(xs.shape[0], 1, jnp.int32)

    def infid(cost):
        return lambda xs, key: (_rosen(xs), torch.full(
            (xs.shape[0],), cost, dtype=torch.int32))

    for maxfev in (60, 600):          # 60 binds; 600 lets most converge
        wx, wf, wn, wit = jnm._nm_while_batched(
            want_s, jax.random.key(0), jinfid, jnp.asarray(lo),
            jnp.asarray(hi), maxfev=maxfev, lanes=6)
        gx, gf, gn, git, stats = nmplus._nm_while_batched(
            got_s, prng.key(0), infid(1), _t(lo), _t(hi), maxfev=maxfev,
            lanes=6)
        np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-10)
        np.testing.assert_allclose(gf.numpy(), wf, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(gn.numpy(), wn)
        np.testing.assert_array_equal(git.numpy(), wit)
        assert git.max() > 3 and stats["syncs"] == stats["rounds"] + 1
        # nfev is a pure evaluation count, invariant to per-call billing
        bx, _, bn, bit, _ = nmplus._nm_while_batched(
            got_s, prng.key(0), infid(50), _t(lo), _t(hi), maxfev=maxfev,
            lanes=6)
        assert torch.equal(bx, gx) and torch.equal(bn, gn)
        assert torch.equal(bit, git)


# ------------------------------------------------------------ objectives


def _specs(n, regime, noise_level=0.05):
    h0j = jchain.xx_hamiltonian_real(n, dtype=jnp.float64)
    fixed_j = fixed_t = None
    if regime == "fixed":
        fixed_j, _ = jnoise.fixed_hamiltonian_ensemble(
            jax.random.key(4), h0j, noise_level, train_size=5, test_size=3)
        fixed_t = _t(fixed_j)
    kw = dict(in_spin=0, out_spin=n - 1, noise=noise_level, fid_noisy=False,
              ham_noisy=regime == "ham_noisy", draws=10, adaptive=False,
              adp_tol=0.05, mul_fac=1)
    return (jobj.ObjectiveSpec(h0=h0j, fixed_hams=fixed_j, **kw),
            objectives.ObjectiveSpec(
                h0=chain.xx_hamiltonian_real(n, **F64), fixed_hams=fixed_t,
                **kw))


def _xs(n, k, seed=5):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(-3, 3, (k, n)),
                            rng.uniform(0.5, 6, k)])


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy", "fixed"])
def test_objectives_match_jax(regime):
    n, k = 4, 12
    js, ts = _specs(n, regime)
    xs = _xs(n, k)
    key_j, key_t = jax.random.key(11), prng.key(11)
    want_f, want_c = jobj.make_infidelity_batch(js)(jnp.asarray(xs), key_j)
    got_f, got_c = objectives.make_infidelity_batch(ts)(_t(xs), key_t)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got_c.numpy(), want_c)

    # forward differences: the values at every probe within 1e-10, so
    # their difference quotient within 1e-10 / eps
    eps = 1e-8
    wf0, wg, wc = jobj.make_fd_gradient_batch(
        jobj.make_infidelity_batch(js), n + 1, eps)(jnp.asarray(xs), key_j)
    gf0, gg, gc = objectives.make_fd_gradient_batch(
        objectives.make_infidelity_batch(ts), n + 1, eps)(_t(xs), key_t)
    np.testing.assert_allclose(gf0.numpy(), wf0, rtol=0, atol=1e-10)
    assert np.abs(gg.numpy() - np.asarray(wg)).max() * eps <= 1e-10
    np.testing.assert_array_equal(gc.numpy(), wc)

    if regime == "ham_noisy":
        wc_, wb = jobj.make_wass_cost_batch(js, 5)(jnp.asarray(xs), key_j)
        gc_, gb = objectives.make_wass_cost_batch(ts, 5)(_t(xs), key_t)
        np.testing.assert_allclose(gc_.numpy(), wc_, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(gb.numpy(), wb)
        assert np.all(gb.numpy() == 5)
    if regime == "noiseless":
        we, wg = jobj.make_exact_gradient_batch(js)(jnp.asarray(xs))
        ge, gg = objectives.make_exact_gradient_batch(ts)(_t(xs))
        np.testing.assert_allclose(ge.numpy(), we, rtol=0, atol=1e-10)
        np.testing.assert_allclose(gg.numpy(), wg, rtol=0, atol=1e-10)


def test_structured_draws_and_fixed_ensemble_match_jax():
    n = 5
    want = jobj._structured_draws_lanes(jax.random.key(2), 9, n, 0.1,
                                        jnp.float64)
    got = objectives._structured_draws_lanes(prng.key(2), 9, n, 0.1,
                                             torch.float64, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-14)
    h0j = jchain.xx_hamiltonian_real(n, dtype=jnp.float64)
    wtr, wte = jnoise.fixed_hamiltonian_ensemble(jax.random.key(4), h0j,
                                                 0.05, train_size=6,
                                                 test_size=4)
    gtr, gte = noise.fixed_hamiltonian_ensemble(
        prng.key(4), chain.xx_hamiltonian_real(n, **F64), 0.05,
        train_size=6, test_size=4)
    np.testing.assert_allclose(gtr.numpy(), wtr, rtol=0, atol=1e-14)
    np.testing.assert_allclose(gte.numpy(), wte, rtol=0, atol=1e-14)


def test_shot_noise_and_mesh_are_refused():
    """Shot noise was refused until it was ported (ROADMAP item 9): the
    objective and ``fidelity_ss(noisy=True)`` now run (held against the
    JAX package in tests/test_torch_shot_noise.py) and give whole tenths of
    draws 10.  ``mesh`` was refused too until it was ported: an L-BFGS on
    a two-entry CPU mesh now takes it, and a batch through it is the
    unsharded batch's restarts (tests/test_torch_parallel.py holds the
    mesh paths).  The Wasserstein cost outside L-BFGS still raises."""
    _, ts = _specs(4, "noiseless")
    f, calls = objectives.make_infidelity_batch(ts._replace(fid_noisy=True))(
        _t(_xs(4, 12)), prng.key(0))
    assert torch.equal(calls, torch.ones(12, dtype=torch.int32))
    assert torch.allclose(f * 10, torch.round(f * 10), atol=1e-12)
    opt = NMPlus(4, 0, 2, testing=True, **F64)
    fid = opt.fidelity_ss(np.ones(5), noisy=True)
    assert 0.0 <= fid <= 1.0 and abs(fid * 10 - round(fid * 10)) < 1e-12
    mesh = Mesh(["cpu"] * 2)
    opt = LBFGS(4, 0, 2, testing=True, mesh=mesh, maxiter=5, **F64)
    assert opt.mesh is mesh
    x0s, keys = _t(_xs(4, 4)), prng.split(prng.key(1), 4)
    res = opt._run_batch_sharded(x0s, keys)
    assert res.x.shape == (4, 5) and bool((res.nfev > 0).all())
    assert torch.equal(res.x[:2], opt._run_batch(x0s[:2], keys[:2]).x)
    with pytest.raises(NotImplementedError):
        NMPlus(4, 0, 2, testing=True, use_wass_cost=True, **F64)
    with pytest.raises(NotImplementedError):
        LBFGS(4, 0, 2, testing=True, use_wass_cost=True, **F64)._batch_fn()


# ---------------------------------------------------------- _run_batch


def _pair(jcls, cls, n=4, out=2, **kw):
    return (jcls(n, 0, out, testing=True, **kw),
            cls(n, 0, out, testing=True, **kw, **F64))


def _assert_restarts_agree(want, got, max_differ=2):
    dx = np.abs(got.x.numpy() - np.asarray(want.x)).max(1)
    same = dx <= 1e-8
    assert same.sum() >= len(dx) - max_differ, (dx.max(), (~same).sum())
    np.testing.assert_array_equal(got.nfev.numpy()[same],
                                  np.asarray(want.nfev)[same])
    np.testing.assert_array_equal(got.nit.numpy()[same],
                                  np.asarray(want.nit)[same])
    np.testing.assert_allclose(got.fid.numpy()[same],
                               np.asarray(want.fid)[same], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.true_fid.numpy()[same],
                               np.asarray(want.true_fid)[same], rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("cls_pair,kw", [
    ((JNMPlus, NMPlus), dict(seed=3)),
    ((JNMPlus, NMPlus), dict(seed=4, ham_noisy=True, noise=0.05, pool=32)),
    ((JNMPlus, NMPlus), dict(seed=5, use_fixed_ham=True, opt_train_size=4,
                             pool=32)),
    ((JLBFGS, LBFGS), dict(seed=3, maxiter=3)),
    ((JLBFGS, LBFGS), dict(seed=7, maxiter=3)),
], ids=["nm", "nm_ham_noisy", "nm_fixed", "lbfgs_3it_s3", "lbfgs_3it_s7"])
def test_run_batch_matches_jax_per_restart(cls_pair, kw):
    """64 restarts (32 for the noisy regimes) on 16 recycled lanes, the
    same starts and keys."""
    pool = kw.pop("pool", 64)
    jopt, opt = _pair(*cls_pair, lane_width=16, **kw)
    x0 = jopt.init_points(pool)
    np.testing.assert_array_equal(opt.init_points(pool), x0)
    jk, tk = _keys(jax.random.key(0), pool)
    want = jopt._run_batch(jnp.asarray(x0), jk)
    got = opt._run_batch(_t(x0), tk)
    _assert_restarts_agree(want, got)
    assert opt.stats["rounds"] > 0 and opt.stats["syncs"] > 0


@pytest.mark.parametrize("seed", [3, 7])
def test_lbfgs_whole_runs_part_from_jax_as_jax_from_itself(seed):
    """Whole L-BFGS runs on the 64-restart N=4 pool.  JAX parts from
    itself, when the starts move by 1e-14, on about as many restarts as the
    port parts from JAX (25 and 24 of 64 for seed 3, 17 and 19 for seed 7):
    the parting is the landscape amplifying rounding, not the port.  The
    restarts that stay together agree in x, nit, nfev and fidelity."""
    jopt, opt = _pair(JLBFGS, LBFGS, seed=seed, lane_width=16)
    x0 = jopt.init_points(64)
    jk, tk = _keys(jax.random.key(0), 64)
    want = jopt._run_batch(jnp.asarray(x0), jk)
    moved = jopt._run_batch(jnp.asarray(x0 + 1e-14), jk)
    got = opt._run_batch(_t(x0), tk)
    self_apart = int((np.abs(np.asarray(moved.x) - np.asarray(want.x))
                      .max(1) > 1e-8).sum())
    assert self_apart >= 8
    _assert_restarts_agree(want, got, max_differ=self_apart + 8)


def test_lbfgs_maxiter_and_nm_budget_bind():
    opt = LBFGS(4, 0, 2, testing=True, lane_width=16, maxiter=3, **F64)
    res = opt._run_batch(_t(opt.init_points(24)), prng.split(prng.key(1),
                                                             24))
    assert int(res.nit.max()) <= 3 and bool((res.nfev > 0).all())
    # noiseless L-BFGS bills d["funcalls"] twice (qnewton.py:558, 562)
    assert bool((res.nfev % 2 == 0).all())


# ------------------------------------------------------------ run() etc.


def test_host_helpers_and_carry_state():
    jopt = JLBFGS(4, 0, 2, seed=21, use_fixed_ham=True, opt_train_size=3,
                  noise=0.05)
    jopt.next_key()
    opt = LBFGS(4, 0, 2, seed=99, use_fixed_ham=True, opt_train_size=3,
                noise=0.05, **F64)
    base.carry_state(opt, jax.random.key_data(jopt._key),
                     np.asarray(jopt.randH), np.asarray(jopt.randH_test))
    assert torch.equal(opt.randH_test, _t(jopt.randH_test))
    # the port's own key(4) ensemble is the JAX one
    own = LBFGS(4, 0, 2, testing=True, use_fixed_ham=True,
                opt_train_size=3, noise=0.05, **F64)
    np.testing.assert_allclose(own.randH.numpy(), jopt.randH, rtol=0,
                               atol=1e-14)
    assert torch.equal(prng.key(7), _t(jax.random.key_data(
        jax.random.key(7)), torch.int64))

    xs = _xs(4, 6, seed=8)
    x = xs[1]
    assert abs(opt.fidelity_ss(x) - jopt.fidelity_ss(x)) < 1e-10
    # the ham-noisy draw consumes next_key on both sides
    assert abs(opt.fidelity_ss(x, ham_noisy=True) -
               jopt.fidelity_ss(x, ham_noisy=True)) < 1e-10
    rh = np.asarray(jopt.randH)[1]
    assert abs(opt.fidelity_ss(x, use_fixed_ham=True, rH=rh) -
               jopt.fidelity_ss(x, use_fixed_ham=True, rH=rh)) < 1e-10
    for test in (False, True):
        assert abs(opt.fidelity_ss_av(x, test=test) -
                   jopt.fidelity_ss_av(x, test=test)) < 1e-10
    we, wg = jopt.eval_static_fidelity_gradient(x)
    ge, gg = opt.eval_static_fidelity_gradient(x)
    assert abs(ge - we) < 1e-10
    np.testing.assert_allclose(gg, wg, rtol=0, atol=1e-10)
    assert opt.find_min_fid_index(xs) == jopt.find_min_fid_index(xs)
    # both keys advanced alike
    np.testing.assert_array_equal(prng.split(opt._key).numpy(),
                                  jax.random.key_data(
                                      jax.random.split(jopt._key)))
