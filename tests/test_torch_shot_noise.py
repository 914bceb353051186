"""The port's binomial shot noise (ops/prng.randint and binomial,
ops/noise.shot_noise_fidelity and adaptive_shot_fidelity,
mc/engine.bootstrap_statistic_std, and ``fid_noisy`` through the zoo's
objectives, ``fidelity_ss``, the env step and the PPO epoch) against the
JAX package on the CPU.

- ``randint`` word for word against ``jax.random.randint`` (int32 and the
  x64 regime's int64), one key with a shape and a batch of keys.
- ``binomial`` against ``jax.random.binomial`` at float32 and float64, on
  20,000 elements a case: counts 1 to 10**4 over a grid of p through 0, 1,
  p > 0.5 and both sides of count * q = 10, so both samplers run; one key
  with a shape and a batch of keys.  The words and the uniforms are the
  reference's; a count may differ where torch's ``log`` and XLA's, one ulp
  apart on some inputs, fall on two sides of a ``ceil``/``floor`` or an
  acceptance bound.  Each case prints its share of differing counts and
  fails above SHARE.
- The protocols per lane against the reference vmapped over keys (under
  jit, as the reference's programs run them: ``shot_noise_fidelity``'s
  division by a constant is then a product with its reciprocal), under
  the same bound; ``bootstrap_statistic_std`` at float64 within 1e-12.
- The ``fid_noisy`` objectives (plain, adaptive, with ham noise, on the
  fixed ensemble) at float64, N=4, 64 lanes; ``fidelity_ss``; one PPO
  epoch (N=4, 8 agents, T=16) step by step as tests/test_torch_ppo.py holds
  the noiseless one; whole noisy NM and L-BFGS runs (N=4, 256 restarts)
  by KS under the zoo's 0.12 gate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu.metrics import stats as jstats
from code_robchar_tpu.models import LBFGS as JLBFGS, NMPlus as JNMPlus
from code_robchar_tpu.models import PPO_en as JPPO_en
from code_robchar_tpu.models import objectives as jobj
from code_robchar_tpu.ops import chain as jchain, noise as jnoise
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.metrics import stats
from code_robchar_tpu_torch.models import LBFGS, NMPlus, PPO_en
from code_robchar_tpu_torch.models import base, objectives, ppo
from code_robchar_tpu_torch.ops import chain, noise, prng

F64 = dict(dtype=torch.float64, device="cpu")
#: the largest share of elements whose draws may differ from the reference
SHARE = 1e-4
#: p through 0 and 1, values above 0.5, and count * q on both sides of 10
#: for every count of the cases below
P_GRID = (0.0, 1.0, 0.0001, 0.001, 0.003, 0.009, 0.011, 0.02, 0.05, 0.09,
          0.11, 0.3, 0.49, 0.5, 0.51, 0.7, 0.89, 0.91, 0.99, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The draws are many small torch operations.  On a loaded machine (the
    suite's parallel workers) torch's OpenMP threads wait on one another
    in every one of them, which made this module run ten times longer;
    one thread keeps its time what it is on an idle machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_keys(keys):
    return prng.key_from_data(np.asarray(jax.random.key_data(keys)))


def _differ(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    with np.errstate(invalid="ignore"):
        same = (np.abs(got - want) <= atol) | (got == want) | \
            (np.isnan(got) & np.isnan(want))
    return float(1.0 - same.mean())


def _hold(label, got, want, atol=1e-12):
    """Fail when more than SHARE of the elements differ by more than
    ``atol``.  A differing draw moves a count by 1, a shot-noise fidelity
    by 1/draws and an adaptive estimate by at least 1/(a + b + draws);
    ``atol`` admits only the one-ulp roundings in which XLA's compiled
    programs differ from one another (a division by a constant taken as a
    product with its reciprocal, a multiply-add contracted)."""
    share = _differ(got, want, atol)
    print(f"{label}: {share:.3e} of {np.asarray(want).size} differ")
    assert share <= SHARE, f"{label}: {share:.3e} differ"


# -------------------------------------------------------------- randint


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 7), (3, 35),
                                   (0, 2 ** 20), (-5, 9995), (0, 10000),
                                   (5, 5), (9, 3), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_matches_jax_word_for_word(dtype, lo, hi):
    key = jax.random.key(3)
    want = jax.random.randint(key, (500,), lo, hi, dtype=dtype)
    got = prng.randint(_port_keys(key), (500,), lo, hi, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys = jax.random.split(key, 7)
    want = jax.vmap(lambda k: jax.random.randint(k, (3, 2), lo, hi,
                                                 dtype=dtype))(keys)
    got = prng.randint(_port_keys(keys), (3, 2), lo, hi, getattr(torch, dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_refuses_spans_it_does_not_cover():
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), (2,), 0, 2 ** 40, torch.int64)
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), (2,), 0, 5, torch.float32)


# ------------------------------------------------------------- binomial


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("count", [1, 10, 100, 1000, 10 ** 4])
def test_binomial_matches_jax(dtype, count):
    p = np.tile(np.asarray(P_GRID, dtype=dtype), 1000)
    use_inv = count * np.minimum(p, 1 - p) <= 10
    if count >= 100:
        assert use_inv.any() and not use_inv.all()    # both samplers run
    key = jax.random.key(count)
    want = jax.random.binomial(key, count, jnp.asarray(p))
    got = prng.binomial(_port_keys(key), count, torch.as_tensor(p))
    assert got.dtype == getattr(torch, dtype)
    _hold(f"binomial {dtype} n={count} one key", got.numpy(), want)
    keys = jax.random.split(key, p.size)
    want = jax.vmap(lambda k, q: jax.random.binomial(k, count, q))(
        keys, jnp.asarray(p))
    got = prng.binomial(_port_keys(keys), count, torch.as_tensor(p))
    _hold(f"binomial {dtype} n={count} batch of keys", got.numpy(), want)


def test_binomial_edge_values_match_jax():
    """NaN for a NaN or negative count and for p NaN or outside [0, 1]
    (q < 0 or NaN); inf for an infinite count; count - k where p >= 0.5,
    a float count floored."""
    count = np.array([np.nan, -3.0, np.inf, 5.0, 5.0, 5.0, 7.9, 20.0, 4.0])
    p = np.array([0.3, 0.3, 0.3, np.nan, -0.2, 1.5, 0.6, 0.0, 1.0])
    key = jax.random.key(8)
    want = jax.random.binomial(key, jnp.asarray(count), jnp.asarray(p))
    got = prng.binomial(_port_keys(key), torch.as_tensor(count),
                        torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binomial_moments():
    """The moment check of tests/test_noise.py: Binomial(10, 0.8) / 10 over
    4000 keys has mean 0.8 and std sqrt(0.8 * 0.2 / 10)."""
    keys = prng.split(prng.key(0), 4000)
    vals = noise.shot_noise_fidelity(keys, torch.full((4000,), 0.8), 10)
    assert abs(float(vals.mean()) - 0.8) < 0.01
    assert abs(float(vals.std(correction=0)) - np.sqrt(0.8 * 0.2 / 10)) < 0.01


# ------------------------------------------------------------ protocols


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shot_protocols_match_jax_per_lane(dtype):
    rng = np.random.default_rng(0)
    fid = rng.uniform(-0.05, 1.05, 5000).astype(dtype)
    keys = jax.random.split(jax.random.key(5), fid.size)
    pk, pf = _port_keys(keys), torch.as_tensor(fid)
    want = jax.jit(jax.vmap(lambda k, f: jnoise.shot_noise_fidelity(
        k, f, 10)))(keys, jnp.asarray(fid))
    _hold(f"shot_noise_fidelity {dtype}",
          noise.shot_noise_fidelity(pk, pf, 10).numpy(), want)
    for tol in (0.05,):
        we, wc = jax.vmap(lambda k, f: jnoise.adaptive_shot_fidelity(
            k, f, 10, tol))(keys, jnp.asarray(fid))
        ge, gc = noise.adaptive_shot_fidelity(pk, pf, 10, tol)
        assert gc.dtype == torch.int32 and int(gc.min()) >= 10
        _hold(f"adaptive estimate {dtype} tol {tol}", ge.numpy(), we)
        _hold(f"adaptive calls {dtype} tol {tol}", gc.numpy(), wc)
    # one key, one fidelity: the host conveniences' form
    we, wc = jnoise.adaptive_shot_fidelity(keys[0], jnp.asarray(fid[0]), 5,
                                           0.01)
    ge, gc = noise.adaptive_shot_fidelity(pk[0], pf[0], 5, 0.01)
    assert float(ge) == float(we) and int(gc) == int(wc) > 5
    with pytest.raises(ValueError, match="adp_tol"):
        noise.adaptive_shot_fidelity(pk[0], pf[0], 5, 0.0)


@pytest.mark.parametrize("name", ["std", "worst case fid", "Q th. 0.95",
                                  r"$W(.,\delta(x-1))$"])
def test_bootstrap_statistic_std_matches_jax(name):
    sample = np.random.default_rng(2).uniform(0.6, 1.0, (3, 50))
    jfn = dict(jstats.metric_registry)[name]
    fn = dict(stats.metric_registry)[name]
    want = jengine.bootstrap_statistic_std(jax.random.key(9),
                                           jnp.asarray(sample), jfn, 100)
    got = engine.bootstrap_statistic_std(prng.key(9), torch.as_tensor(sample),
                                         fn, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert float(got.min()) > 0.0


# ----------------------------------------------------- fid_noisy paths


def _specs(n, regime, adaptive=False):
    h0j = jchain.xx_hamiltonian_real(n, dtype=jnp.float64)
    fixed_j = fixed_t = None
    if regime == "fixed":
        fixed_j, _ = jnoise.fixed_hamiltonian_ensemble(
            jax.random.key(4), h0j, 0.05, train_size=5, test_size=3)
        fixed_t = torch.as_tensor(np.asarray(fixed_j))
    kw = dict(in_spin=0, out_spin=n - 1, noise=0.05, fid_noisy=True,
              ham_noisy=regime == "ham_noisy", draws=10, adaptive=adaptive,
              adp_tol=0.05, mul_fac=1)
    return (jobj.ObjectiveSpec(h0=h0j, fixed_hams=fixed_j, **kw),
            objectives.ObjectiveSpec(h0=chain.xx_hamiltonian_real(n, **F64),
                                     fixed_hams=fixed_t, **kw))


@pytest.mark.parametrize("regime,adaptive", [("plain", False),
                                             ("plain", True),
                                             ("ham_noisy", False),
                                             ("ham_noisy", True),
                                             ("fixed", False)])
def test_fid_noisy_objectives_match_jax(regime, adaptive):
    n, k = 4, 64
    js, ts = _specs(n, regime, adaptive)
    rng = np.random.default_rng(5)
    xs = np.column_stack([rng.uniform(-3, 3, (k, n)), rng.uniform(0.5, 6, k)])
    key = jax.random.key(11)
    want_f, want_c = jax.jit(jobj.make_infidelity_batch(js))(
        jnp.asarray(xs), key)
    got_f, got_c = objectives.make_infidelity_batch(ts)(
        torch.as_tensor(xs), _port_keys(key))
    _hold(f"objective {regime} adaptive={adaptive}", got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.dtype == torch.int32
    if adaptive:
        assert int(got_c.min()) >= 2 * ts.draws

    if regime != "plain":
        return
    # forward differences: every probe's value (K * (d + 1) lanes) and the
    # summed calls
    fd = objectives.make_fd_gradient_batch(objectives.make_infidelity_batch(ts),
                                           n + 1)
    jfd = jax.jit(jobj.make_fd_gradient_batch(jobj.make_infidelity_batch(js),
                                              n + 1))
    wf0, wg, wc = jfd(jnp.asarray(xs), key)
    gf0, gg, gc = fd(torch.as_tensor(xs), _port_keys(key))
    _hold(f"fd f0 {regime}", gf0.numpy(), wf0)
    _hold(f"fd gradient {regime}", gg.numpy(), wg, atol=1e-12 / 1e-8)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("adaptive", [False, True])
def test_fidelity_ss_noisy_matches_jax(adaptive):
    kw = dict(testing=True, seed=3, fid_noisy=True, ham_noisy=True,
              adaptive=adaptive)
    jopt = JNMPlus(4, 0, 2, **kw)
    opt = base.carry_state(NMPlus(4, 0, 2, **kw, **F64),
                           jax.random.key_data(jopt._key))
    x = np.array([0.5, -1.0, 2.0, 0.3, 2.5])
    for _ in range(3):
        want = jopt.fidelity_ss(x, noisy=True, ham_noisy=True)
        got = opt.fidelity_ss(x, noisy=True, ham_noisy=True)
        # the JAX package divides by a traced ``draws`` here, the port as
        # its compiled programs do (ops/noise.shot_noise_fidelity): one ulp
        assert got == pytest.approx(want, rel=3e-16, abs=0)
    assert opt.fidelity_ss(x) == pytest.approx(jopt.fidelity_ss(x),
                                               abs=1e-12)


@pytest.mark.parametrize("adaptive", [False, True])
def test_ppo_epoch_under_shot_noise_matches_jax(adaptive):
    """One epoch with shot noise on the reward, N=4, 8 agents, T=16, from
    one carried JAX AgentState, on the per-step loop (the fused rollout is
    gated off under fid_noisy): rewards (whole tenths, or adaptive
    estimates) and the calls each step billed equal, the trajectory, true
    fidelities and new parameters to 1e-10."""
    epoch = (16, 0.2, 3e-3, 1e-3, 1000, 2, 3, 0.01)
    kw = dict(testing=True, num_agents=8, seed=7, ham_noisy=True,
              fid_noisy=True, adaptive=adaptive, fused_critic=False)
    jp = JPPO_en(4, 0, 2, fused_rollout=False, **kw)
    assert jp._fused_rollout_gate(False, True, True, 8)
    st = jax.tree.map(lambda x: x.astype(jnp.float64)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      jax.vmap(jp._init_agent)(
                          jax.random.split(jax.random.key(0), 8)))
    jst2, jout = jp._build_epoch(*epoch)(st)
    p = PPO_en(4, 0, 2, **kw, **F64)
    assert p.fused_rollout_fallback_reasons()
    pst = ppo.agent_state_from_jax(st, jax.random.key_data(st.key))
    pst2, out = p._build_epoch(*epoch)(pst)
    _hold(f"ppo rewards adaptive={adaptive}", out.rewards.numpy(),
          jout.rewards)
    np.testing.assert_array_equal(out.fcalls.numpy(), np.asarray(jout.fcalls))
    if adaptive:
        assert int(out.fcalls.min()) >= 20
    for name in ("true_fids", "stores"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.pi_iters.numpy(),
                                  np.asarray(jout.pi_iters))
    want = ppo.ac.params_from_jax(jst2.params)
    for k, w in want.items():
        np.testing.assert_allclose(pst2.params[k].numpy(), w.numpy(),
                                   atol=1e-10, rtol=0, err_msg=k)


@pytest.mark.parametrize("cls,jcls", [(NMPlus, JNMPlus), (LBFGS, JLBFGS)])
def test_noisy_whole_runs_match_jax_by_ks(cls, jcls):
    """Whole runs under shot noise (N=4, 256 restarts, draws 10): the final
    fidelities against the reference's by KS under the zoo's 0.12 gate,
    and the billed calls in mean within 1%."""
    kw = dict(testing=True, seed=7, fid_noisy=True, draws=10)
    jopt, opt = jcls(4, 0, 2, **kw), cls(4, 0, 2, **kw, **F64)
    x0 = jopt.init_points(256)
    keys = jax.random.split(jax.random.key(0), 256)
    want = jopt._run_batch(jnp.asarray(x0), keys)
    got = opt._run_batch(torch.as_tensor(np.asarray(x0)), _port_keys(keys))
    stat = scipy.stats.ks_2samp(got.fid.numpy(), np.asarray(want.fid)).statistic
    print(f"{cls.__name__} noisy whole runs: KS {stat:.4f}, restarts equal "
          f"to 1e-9 {np.mean(np.abs(got.fid.numpy() - want.fid) < 1e-9)}")
    assert stat < 0.12
    assert abs(float(got.nfev.double().mean()) /
               float(np.asarray(want.nfev).mean()) - 1) < 0.01
