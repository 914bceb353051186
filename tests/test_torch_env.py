"""The port's PPO environment (code_robchar_tpu_torch/models/env.py)
against the JAX package's, on the CPU at float64: the pure step in its
noiseless, ham_noisy and fixed-ensemble branches for the same key, the
action wrap and time modulus at their boundaries, the batched true
fidelity, and the stateful ``Environment`` wrapper for the same seed.
Physics agrees to 1e-10 (the repo's parity bar); the wrap and the modulus
are the same floor remainder, so they agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.models import env as jenv
from code_robchar_tpu_torch.models import env
from code_robchar_tpu_torch.ops import prng

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


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _key(seed):
    jk = jax.random.key(seed)
    return jk, prng.key_from_data(np.asarray(jax.random.key_data(jk)))


def _cfg(n=4, ham_noisy=False, noise=0.05, bmax=10.0, maxtime=30.0):
    kw = dict(n=n, in_spin=0, out_spin=n - 1, bmax=bmax, maxtime=maxtime,
              noise=noise, fid_noisy=False, ham_noisy=ham_noisy, draws=10,
              adaptive=False, adp_tol=0.05)
    return jenv.EnvConfig(**kw), env.EnvConfig(**kw)


def test_wrap_action_at_its_boundaries():
    bmax = 10.0
    rows = [[-25.0, 3.0, 0.0], [25.0, -3.0, 0.0], [10.0, -10.0, 0.0],
            [10.0000001, 1.0, -1.0], [-10.0000001, 1.0, -1.0],
            [20.0, 0.0, -0.5], [-20.0, 0.0, 0.5], [9.99, -9.99, 0.0],
            [0.0, 0.0, 0.0], [-0.0, 30.0, -30.0], [1e-300, -11.0, 5.0],
            [-1e-300, 11.0, -5.0], [10.5, 10.0, -10.0]]
    rng = np.random.default_rng(0)
    a = np.concatenate([np.asarray(rows), rng.normal(0, 12, (200, 3))])
    want = np.asarray(jenv._wrap_action(jnp.asarray(a), bmax))
    got = env._wrap_action(_t(a), bmax).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrap is per vector: one entry over bmax wraps all of them, which
    # shows on the entries exactly at +-bmax
    np.testing.assert_array_equal(got[2], [10.0, -10.0, 0.0])
    np.testing.assert_array_equal(got[12], [0.5, 0.0, 0.0])
    assert got[0, 0] == -5.0 and got[1, 0] == 5.0


def test_normalise_time_at_its_boundaries():
    maxtime = 30.0
    t = np.concatenate([[-61.0, -60.0, -30.0, -29.9, -0.0, 0.0, 29.9, 30.0,
                         30.0000001, 60.0, 90.5, 1e4, -1e4],
                        np.random.default_rng(1).normal(0, 50, 200)])
    want = np.asarray(jenv._normalise_time(jnp.asarray(t), maxtime))
    np.testing.assert_array_equal(
        env._normalise_time(_t(t), maxtime).numpy(), want)


@pytest.mark.parametrize("ham_noisy", [False, True])
def test_env_step_matches_jax(ham_noisy):
    n = 4
    jcfg, cfg = _cfg(n, ham_noisy=ham_noisy)
    rng = np.random.default_rng(2)
    h0 = np.asarray(jenv.chain.xx_hamiltonian_real(n))
    step = jax.jit(jenv.env_step, static_argnums=0)
    for i in range(6):
        action = rng.normal(0, 6, n)
        t0 = rng.uniform(-40, 40)
        a_bias, a_time = rng.normal(0, 3, n), rng.normal(0, 5)
        jk, pk = _key(10 + i)
        jst = jenv.EnvState(jnp.asarray(action), jnp.asarray(t0),
                            jnp.asarray(30.0))
        pst = env.EnvState(_t(action), _t(t0), _t(30.0))
        want = step(jcfg, jnp.asarray(h0), jst, jnp.asarray(a_bias),
                    jnp.asarray(a_time), jk)
        got = env.env_step(cfg, _t(h0), pst, _t(a_bias), _t(a_time), pk)
        for w, g in zip(want[0], got[0]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
        for w, g in zip(want[1:5], got[1:5]):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=TOL)
        assert int(got[5]) == int(want[5]) == 1


def test_env_step_fixed_ensemble_matches_jax():
    n = 4
    jcfg, cfg = _cfg(n)
    h0 = np.asarray(jenv.chain.xx_hamiltonian_real(n))
    jtrain, _ = jenv.noise_ops.fixed_hamiltonian_ensemble(
        jax.random.key(4), jnp.asarray(h0), 0.05, train_size=7,
        test_size=3, complex_offdiag=False)
    rng = np.random.default_rng(3)
    action, a_bias = rng.normal(0, 2, n), rng.normal(0, 2, n)
    jk, pk = _key(5)
    want = jenv.env_step(
        jcfg, jnp.asarray(h0),
        jenv.EnvState(jnp.asarray(action), jnp.asarray(2.0),
                      jnp.asarray(30.0)),
        jnp.asarray(a_bias), jnp.asarray(1.5), jk, fixed_hams=jtrain)
    got = env.env_step(cfg, _t(h0),
                       env.EnvState(_t(action), _t(2.0), _t(30.0)),
                       _t(a_bias), _t(1.5), pk, fixed_hams=_t(jtrain))
    for w, g in zip(want[1:5], got[1:5]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL)


def test_true_fidelity_batch_matches_jax():
    n = 5
    jcfg, cfg = _cfg(n)
    rng = np.random.default_rng(4)
    h0 = np.asarray(jenv.chain.xx_hamiltonian_real(n))
    stores = np.column_stack([rng.uniform(-10, 10, (40, n)),
                              rng.uniform(0, 30, 40)])
    want = jenv.true_fidelity_batch(jcfg, jnp.asarray(h0),
                                    jnp.asarray(stores))
    got = env.true_fidelity_batch(cfg, _t(h0), _t(stores))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("kw", [dict(ham_noisy=True),
                                dict(transfer_learning=True),
                                dict(use_fixed_ham=True, opt_train_size=5)])
def test_environment_wrapper_matches_jax(kw):
    args = (4, 0, 3)
    jw = jenv.Environment(*args, seed=3, **kw)
    pw = env.Environment(*args, seed=3, dtype=torch.float64, device="cpu",
                         **kw)
    np.testing.assert_allclose(pw.sys.numpy(), np.asarray(jw.sys), atol=TOL)
    if kw.get("use_fixed_ham"):
        np.testing.assert_allclose(pw.randH.numpy(), np.asarray(jw.randH),
                                   atol=TOL)
    rng = np.random.default_rng(5)
    for _ in range(2):
        step = np.diag(rng.normal(0, 4, 4))
        jw.timestep = pw.timestep = float(rng.uniform(-5, 40))
        want, got = jw.step(step), pw.step(step)
        np.testing.assert_allclose(got[0], want[0], atol=TOL)
        assert abs(got[1] - want[1]) < TOL and got[2] == want[2]
        assert abs(pw.tf - jw.tf) < TOL
        assert abs(pw.fidelity() - jw.fidelity()) < TOL
        assert abs(pw.true_fid(step, 3.0) - jw.true_fid(step, 3.0)) < TOL
    jw.action = pw.action = np.asarray([12.0, -3.0, 25.0, 0.0])
    jw.timestep = pw.timestep = -75.0
    jw.normalize()
    pw.normalize()
    np.testing.assert_array_equal(pw.action, jw.action)
    assert pw.timestep == jw.timestep
    jw.reinit_sys_hamiltonian()
    pw.reinit_sys_hamiltonian()
    jw.change_sys_ham(0.2)
    pw.change_sys_ham(0.2)
    np.testing.assert_allclose(pw.sys.numpy(), np.asarray(jw.sys), atol=TOL)
    assert np.all(pw.reset() == 0) and pw.timestep == 0.0


def test_shot_noise_raises_naming_its_item():
    """Shot noise on the reward was refused until it was ported (ROADMAP
    item 9); the step now draws it from ``ks`` of ``split(key)`` as the
    JAX package does: the reward within one ulp of the reference's (the
    reference divides by ``draws`` exactly when run outside jit, the port
    as the compiled programs do, ops/noise.shot_noise_fidelity) and the
    billed calls equal, in the plain and the adaptive protocol."""
    h0 = np.asarray(jenv.chain.xx_hamiltonian_real(4))
    rng = np.random.default_rng(3)
    action = rng.normal(size=4)
    jst = jenv.EnvState(jnp.asarray(action), jnp.asarray(2.0),
                        jnp.asarray(30.0))
    st = env.EnvState(_t(action), _t(2.0), _t(30.0))
    for i in range(4):
        adaptive = i % 2 == 1
        jcfg, cfg = (c._replace(fid_noisy=True, adaptive=adaptive)
                     for c in _cfg(4, ham_noisy=True))
        jk, pk = _key(i)
        a = rng.normal(size=4)
        want = jenv.env_step(jcfg, jnp.asarray(h0), jst, jnp.asarray(a),
                             jnp.asarray(1.5), jk)
        got = env.env_step(cfg, _t(h0), st, _t(a), _t(1.5), pk)
        assert float(got[2]) == pytest.approx(float(want[2]), rel=3e-16,
                                              abs=1e-17)
        assert int(got[5]) == int(want[5]) and got[5].dtype == torch.int32
        assert (int(got[5]) >= 20) == adaptive


def test_env_reset():
    _, cfg = _cfg(5)
    st, obs = env.env_reset(cfg, dtype=torch.float64)
    assert obs.shape == (6,) and float(obs.abs().sum()) == 0.0
    assert float(st.final_time) == 30.0


@pytest.mark.parametrize("seed", [3, 11])
def test_environment_reference_shims_match_jax(seed):
    """The four reference-API methods: ``structured_perturabation`` from
    the env's key stream (the next key after the same construction), real
    off the diagonal and Hermitian, on the env's device; ``state_vector``,
    ``input_state`` and ``output_state``."""
    jw = jenv.Environment(5, 1, 3, seed=seed)
    pw = env.Environment(5, 1, 3, seed=seed, dtype=torch.float64,
                         device="cpu")
    for noise in (0.05, 0.2):
        want = jw.structured_perturabation(noise)
        got = pw.structured_perturabation(noise)
        assert got.device == pw.device and got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
        assert float(got.imag.abs().max()) == 0.0
        assert torch.equal(got, got.mH)
        assert float(got.abs().max()) > 0.0
    for occ in range(5):
        np.testing.assert_array_equal(pw.state_vector(occ),
                                      jw.state_vector(occ))
    np.testing.assert_array_equal(pw.input_state(), jw.input_state())
    np.testing.assert_array_equal(pw.output_state(), jw.output_state())
    assert pw.input_state()[1, 1] == 1 and pw.output_state()[3, 3] == 1
    # the stream moved on as the JAX env's did: the next steps agree
    step = np.diag(np.linspace(-2, 2, 5))
    pw.timestep = jw.timestep = 4.0
    assert abs(pw.step(step)[1] - jw.step(step)[1]) < TOL
