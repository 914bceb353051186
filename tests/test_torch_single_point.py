"""The port's single-point objectives (models/objectives.py
``make_infidelity``, ``make_exact_gradient``, ``make_fd_gradient``,
``make_wass_cost``) and the base's single-controller helpers against the
JAX package, on the CPU at float64 and small sizes (N=4).

- ``make_infidelity`` in six regimes (noiseless, ham_noisy, fid_noisy plain
  and adaptive, the fixed ensemble alone and with shot noise): one point
  and a K=12 batch with the same keys against ``jax.vmap`` of the JAX
  builder, values within 1e-10 and call counts equal.  The same draws for
  the same keys show in the 1e-10: a draw that differed would move the
  fidelity by ~1e-2.
- ``make_exact_gradient`` within 1e-10 at float64, and at float32 within
  1e-4 of the float64 reference on random controllers and on the ring's
  exactly degenerate spectrum (tests/test_realform.py's bar).
- ``make_fd_gradient`` with tests/test_torch_zoo.py's bar: f0 within
  1e-10, the difference quotient within 1e-10 / eps, calls equal.  The
  float32 step (``fd_eps``, which the JAX package does not have): the
  gradient within 1e-2 of the exact one, and noisy L-BFGS leaves its
  starts.
- ``make_wass_cost`` within 1e-10, also across its chunks.
- The base helpers against a JAX optimizer with the same seed:
  ``wass_cost``, ``overlap_ss``, ``structured_perturabation`` and
  ``randHset_constructor`` within 1e-14, ``directional_perturbation``'s
  pick and layout exactly on keys that pick diagonal and off-diagonal
  pairs (its normal values within one ulp, as prng.normal's),
  ``whole_sphere_sampling`` exactly under one numpy seed, ``ngd`` over 50
  steps within 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.models import NMPlus as JNMPlus
from code_robchar_tpu.models import objectives as jobj
from code_robchar_tpu.ops import chain as jchain, noise as jnoise
from code_robchar_tpu_torch.models import NMPlus, objectives
from code_robchar_tpu_torch.ops import chain, noise, prng

N = 4
F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _keys(seed, k):
    """(JAX keys, port keys) of split(key(seed), k)."""
    jk = jax.random.split(jax.random.key(seed), k)
    return jk, prng.key_from_data(np.asarray(jax.random.key_data(jk)))


def _xs(k, seed=5, n=N):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(-3, 3, (k, n)),
                            rng.uniform(0.5, 6, k)])


REGIMES = {
    "noiseless": {},
    "ham_noisy": dict(ham_noisy=True),
    "fid_noisy": dict(fid_noisy=True),
    "adaptive": dict(fid_noisy=True, adaptive=True),
    "fixed": dict(fixed=True),
    "fixed_fid_noisy": dict(fixed=True, fid_noisy=True),
}


def _specs(regime, h0=None, noise_level=0.05):
    kw = dict(REGIMES[regime])
    h0j = jnp.asarray(h0) if h0 is not None else \
        jchain.xx_hamiltonian_real(N, dtype=jnp.float64)
    fixed_j = fixed_t = None
    if kw.pop("fixed", False):
        fixed_j, _ = jnoise.fixed_hamiltonian_ensemble(
            jax.random.key(4), h0j, noise_level, train_size=5, test_size=3)
        fixed_t = _t(fixed_j)
    base = dict(in_spin=0, out_spin=N - 1, noise=noise_level,
                fid_noisy=False, ham_noisy=False, draws=10, adaptive=False,
                adp_tol=0.05, mul_fac=1)
    base.update(kw)
    return (jobj.ObjectiveSpec(h0=h0j, fixed_hams=fixed_j, **base),
            objectives.ObjectiveSpec(h0=_t(h0j), fixed_hams=fixed_t,
                                     **base))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_make_infidelity_matches_vmapped_jax(regime):
    js, ts = _specs(regime)
    xs = _xs(12)
    jk, tk = _keys(11, 12)
    want_f, want_c = jax.jit(jax.vmap(jobj.make_infidelity(js)))(
        jnp.asarray(xs), jk)
    f = objectives.make_infidelity(ts)
    got_f, got_c = f(_t(xs), tk)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    # one point with its own key: a scalar, the batch's first entry
    f0, c0 = f(_t(xs[0]), tk[0])
    assert f0.shape == () and c0.shape == ()
    assert abs(float(f0) - float(want_f[0])) <= TOL
    assert int(c0) == int(want_c[0])
    if regime == "adaptive":
        assert got_c.numpy().min() >= 10     # the protocol bills its shots


def test_make_exact_gradient_matches_jax():
    js, ts = _specs("noiseless")
    xs = _xs(12, seed=6)
    we, wg = jax.jit(jax.vmap(jobj.make_exact_gradient(js)))(jnp.asarray(xs))
    ge, gg = objectives.make_exact_gradient(ts)(_t(xs))
    np.testing.assert_allclose(ge.numpy(), we, rtol=0, atol=TOL)
    np.testing.assert_allclose(gg.numpy(), wg, rtol=0, atol=TOL)
    e1, g1 = objectives.make_exact_gradient(ts)(_t(xs[3]))
    assert e1.shape == () and g1.shape == (N + 1,)
    np.testing.assert_allclose(g1.numpy(), wg[3], rtol=0, atol=TOL)


def test_make_exact_gradient_float32_on_the_degenerate_ring():
    """float32 within 1e-4 of the float64 reference, on the N=4 chain and
    on the ring (doubly degenerate spectrum) with biases of scale 0, 1e-4
    and 1e-2."""
    ring = np.eye(N, k=1) + np.eye(N, k=-1)
    ring[0, N - 1] = ring[N - 1, 0] = 1.0
    rng = np.random.default_rng(42)
    for h0 in (None, ring):
        js, _ = _specs("noiseless", h0=h0)
        cases = [np.concatenate([rng.uniform(-s, s, N),
                                 rng.uniform(2.0, 20.0, 1)])
                 for s in (0.0, 1e-4, 1e-2, 3.0) for _ in range(4)]
        xs = np.asarray(cases)
        _, wg = jax.jit(jax.vmap(jobj.make_exact_gradient(js)))(
            jnp.asarray(xs))
        spec32 = objectives.ObjectiveSpec(*_specs("noiseless", h0=h0)[1])
        spec32 = spec32._replace(h0=spec32.h0.float())
        _, gg = objectives.make_exact_gradient(spec32)(_t(xs, torch.float32))
        err = np.abs(gg.double().numpy() - np.asarray(wg)).max()
        assert err < 1e-4, f"float32 gradient off by {err:.2e}"


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy", "adaptive"])
def test_make_fd_gradient_matches_jax(regime):
    js, ts = _specs(regime)
    xs = _xs(6, seed=7)
    jk, tk = _keys(12, 6)
    eps = 1e-8
    wf0, wg, wc = jax.jit(jax.vmap(jobj.make_fd_gradient(
        jobj.make_infidelity(js), N + 1, eps)))(jnp.asarray(xs), jk)
    gf0, gg, gc = objectives.make_fd_gradient(
        objectives.make_infidelity(ts), N + 1, eps)(_t(xs), tk)
    np.testing.assert_allclose(gf0.numpy(), wf0, rtol=0, atol=TOL)
    assert np.abs(gg.numpy() - np.asarray(wg)).max() * eps <= TOL
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert gc.numpy().min() >= N + 2


def test_fd_step_resolves_float32():
    """The forward-difference step (objectives.fd_eps): the JAX package's
    1e-8 at float64, sqrt of the machine epsilon at float32.  At float32
    the 1e-8 step gives a zero gradient on every coordinate of 32 seeded
    controllers; the float32 step's batched gradient (sigma 0 ham noise,
    the collect's lbfgs cell) lies within 1e-2 of the exact float64
    gradient (its error is ~3e-3: rounding ~6e-8 / 3.45e-4 and the
    truncation).  A float32 noisy L-BFGS batch of 16 Sobol starts moves
    every start it iterates and beats its best start."""
    from code_robchar_tpu_torch.models import LBFGS

    assert objectives.fd_eps(torch.float64) == 1e-8
    assert objectives.fd_eps(torch.float32) == pytest.approx(2.0 ** -11.5)
    assert objectives.fd_eps(torch.float32, 1e-3) == 1e-3
    xs = _xs(32, seed=5)
    exact = LBFGS(N, 0, 2, testing=True, **F64)
    _, want = objectives.make_exact_gradient_batch(exact.spec())(_t(xs))
    opt = LBFGS(N, 0, 2, ham_noisy=True, noise=0.0, testing=True,
                device="cpu", dtype=torch.float32)
    infid = objectives.make_infidelity_batch(opt.spec())
    x32 = _t(xs, torch.float32)
    _, g_old, _ = objectives.make_fd_gradient_batch(infid, N + 1, 1e-8)(
        x32, prng.key(0))
    assert bool((g_old == 0).all())
    _, g, _ = objectives.make_fd_gradient_batch(infid, N + 1)(x32,
                                                            prng.key(0))
    assert float(want.abs().max()) > 0.5
    assert float((g.double() - want).abs().max()) <= 1e-2

    x0 = torch.as_tensor(opt.init_points(16), dtype=torch.float32)
    res = opt._run_batch(x0, prng.split(prng.key(0), 16))
    moved = (res.x != x0).any(1)
    assert bool(moved[res.nit > 1].all()) and int(moved.sum()) >= 12
    best0 = float(objectives.fidelity_batch(opt.HH, x0, 0, 2).max())
    assert float(res.true_fid.max()) > best0 + 0.1


def test_make_wass_cost_matches_jax(monkeypatch):
    js, ts = _specs("ham_noisy")
    xs = _xs(12, seed=8)
    jk, tk = _keys(13, 12)
    want = jax.jit(jax.vmap(jobj.make_wass_cost(js, 5)))(jnp.asarray(xs), jk)
    got = objectives.make_wass_cost(ts, 5)(_t(xs), tk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert float(got.min()) > 0.0
    # chunks of 2 controllers (10 Hamiltonians) draw what one batch draws
    monkeypatch.setattr(objectives, "WASS_LANES", 10)
    chunked = objectives.make_wass_cost(ts, 5)(_t(xs), tk)
    np.testing.assert_array_equal(chunked.numpy(), got.numpy())


# ------------------------------------------------------- base helpers


def _pair(seed=3, **kw):
    """A JAX NMPlus and a port one with the same seed (same keys)."""
    return (JNMPlus(N, 0, N - 1, testing=True, seed=seed, **kw),
            NMPlus(N, 0, N - 1, testing=True, seed=seed, **F64, **kw))


def test_base_helpers_match_jax():
    jopt, opt = _pair(noise=0.07)
    x = _xs(1, seed=9)[0]
    assert abs(opt.wass_cost(x, 7) - jopt.wass_cost(x, 7)) <= 1e-14
    assert abs(opt.overlap_ss(x) - jopt.overlap_ss(x)) <= 1e-14
    for _ in range(3):
        np.testing.assert_allclose(
            opt.structured_perturabation().numpy(),
            np.asarray(jopt.structured_perturabation()), rtol=0, atol=1e-14)
    wtr, wte = jopt.randHset_constructor(train_size=6, test_size=4)
    gtr, gte = opt.randHset_constructor(train_size=6, test_size=4)
    np.testing.assert_allclose(gtr.numpy(), wtr, rtol=0, atol=1e-14)
    np.testing.assert_allclose(gte.numpy(), wte, rtol=0, atol=1e-14)
    assert opt.sys_hamiltonian() is opt.HH
    np.testing.assert_array_equal(opt.controls().numpy(),
                                  np.asarray(jopt.controls()))
    # the keys advanced in step: the next draw is still the same
    np.testing.assert_allclose(opt.structured_perturabation().numpy(),
                               np.asarray(jopt.structured_perturabation()),
                               rtol=0, atol=1e-14)


def test_directional_perturbation_matches_jax():
    """On 40 keys, both kinds of pick: the pair picked is the reference's
    exactly, and so is the layout (a diagonal pick holds conj(val) alone,
    an off-diagonal one val and its conjugate, bit for bit).  The values
    are normal draws, which prng.normal reproduces to one ulp (its log1p,
    ops/prng.py)."""
    kinds = set()
    for seed in range(40):
        jk = jax.random.key(seed)
        want = np.asarray(jnoise.directional_perturbation(jk, 5, 0.3))
        got = noise.directional_perturbation(
            prng.key(seed), 5, 0.3, dtype=torch.complex128).numpy()
        np.testing.assert_array_equal(np.argwhere(got != 0),
                                      np.argwhere(want != 0))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
        np.testing.assert_array_equal(got, got.T.conj()
                                      if np.count_nonzero(got) == 2 else got)
        i, j = np.argwhere(want != 0)[0]
        kinds.add("diagonal" if i == j else "off-diagonal")
        assert np.count_nonzero(want) == (1 if i == j else 2)
    assert kinds == {"diagonal", "off-diagonal"}
    jopt, opt = _pair()
    for _ in range(4):
        np.testing.assert_allclose(opt.directional_perturbation().numpy(),
                                   np.asarray(jopt.directional_perturbation()),
                                   rtol=0, atol=1e-15)


def test_whole_sphere_sampling_is_exact():
    np.random.seed(17)
    want = JNMPlus.whole_sphere_sampling(50, 5)
    np.random.seed(17)
    got = NMPlus.whole_sphere_sampling(50, 5)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.linalg.norm(got, axis=1) <= 1.0 / 5)


def test_ngd_matches_jax():
    jopt, opt = _pair(seed=4, noise=0.05)
    ww, wf = jopt.ngd(50, lr=1e-2)
    gw, gf = opt.ngd(50, lr=1e-2)
    np.testing.assert_allclose(gw, ww, rtol=0, atol=TOL)
    assert abs(gf - wf) <= TOL
    start = NMPlus(N, 0, N - 1, testing=True, seed=4, **F64).init_points(1)
    assert np.abs(gw - start[0]).max() > 1e-3             # it moved
