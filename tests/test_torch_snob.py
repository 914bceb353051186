"""The port's SNOB (code_robchar_tpu_torch/models/snob.py) against the JAX
package, on the CPU at N=4 and float64.

- The rounds of a whole 300-evaluation budget (30 rounds of 10
  candidates a restart, 16 restarts), noiseless, ham_noisy and on the
  fixed ensemble: after every round best_x, best_f and the trust radius
  within 1e-9, and nfev equal.  The JAX side is the reference's own round
  body, compiled and driven one round at a time, so that its state after
  each round can be read.
- The key chain and the draws of the rounds: keys and uniforms bit for
  bit, normals within 1e-14 (torch's log1p and XLA's contraction of the
  erf_inv polynomial round differently by an ulp or two).
- ``_run_batch`` (the ranking by the history's minimum, the clean true
  fidelities, the fixed-ensemble trues) and the billing of ``run()``:
  flat (budget a restart), fixed-ham (budget x train_size) and the
  adaptive protocol's in-band counts, against the JAX package's records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_robchar_tpu.models import SNOB as JSNOB
from code_robchar_tpu.models import objectives as jobj
from code_robchar_tpu.models import snob as jsnob
from code_robchar_tpu_torch.models import SNOB, base, objectives
from code_robchar_tpu_torch.models import snob as tsnob
from code_robchar_tpu_torch.ops import prng

F64 = dict(dtype=torch.float64, device="cpu")
K = 16
REGIMES = {"noiseless": {},
           "ham_noisy": dict(ham_noisy=True, noise=0.05),
           "fixed": dict(use_fixed_ham=True, opt_train_size=4, noise=0.05)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch operations: one thread keeps the module's time on
    a loaded machine what it is on an idle one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(regime="noiseless", seed=5, **kw):
    kw = dict(REGIMES[regime], testing=True, seed=seed, **kw)
    jopt, opt = JSNOB(4, 0, 2, **kw), SNOB(4, 0, 2, **kw, **F64)
    if jopt.use_fixed_ham:
        base.carry_state(opt, jax.random.key_data(jopt._key),
                         np.asarray(jopt.randH), np.asarray(jopt.randH_test))
    return jopt, opt


def _jax_rounds(monkeypatch, x0, key, infid_b, lower, upper, budget):
    """The reference's ``_snob_restarts_batched`` with its round loop
    driven from the host: the round body compiled once and called round by
    round (``lax.fori_loop`` with the same bounds and carry), so that the
    state after each round is seen.  Other loops run as they are."""
    rounds, fori = [], jax.lax.fori_loop

    def stepped(lo, hi, body, init):
        if body.__name__ != "round_body":
            return fori(lo, hi, body, init)
        step, carry = jax.jit(body), init
        for i in range(lo, hi):
            carry = step(i, carry)
            rounds.append(carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", stepped)
    out = jsnob._snob_restarts_batched(x0, key, infid_b, lower, upper,
                                       budget)
    monkeypatch.setattr(jax.lax, "fori_loop", fori)
    return out, rounds


@pytest.mark.parametrize("regime", list(REGIMES))
def test_snob_rounds_match_jax_f64(monkeypatch, regime):
    jopt, opt = _pair(regime)
    x0 = jopt.init_points(K)
    np.testing.assert_array_equal(opt.init_points(K), x0)
    (wx, wf, wn), want = _jax_rounds(
        monkeypatch, jnp.asarray(x0), jax.random.key(9),
        jobj.make_infidelity_batch(jopt.spec()), jopt._lower, jopt._upper,
        300)
    got, real = [], tsnob._round

    def observed(*args):
        carry = real(*args)
        got.append(carry)
        return carry

    monkeypatch.setattr(tsnob, "_round", observed)
    gx, gf, gn = tsnob._snob_restarts_batched(
        torch.as_tensor(x0), prng.key(9),
        objectives.make_infidelity_batch(opt.spec()), opt._lower,
        opt._upper, 300)
    assert len(got) == len(want) == 30
    for r, (g, w) in enumerate(zip(got, want)):
        for name, gs, ws in zip(("best_x", "best_f", "radius"), g, w[:3]):
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0,
                                       atol=1e-9, err_msg=f"round {r} {name}")
        # the same argmins: the radius grew or shrank alike
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert bool((gn == 301).all())       # the start and 30 rounds of 10


def test_snob_round_draws_match_jax():
    """The chain of ``split(key, 4)`` and each round's draws (2 normals and
    7 uniforms a restart and coordinate) for 30 rounds."""
    key, tkey = jax.random.key(9), prng.key(9)
    key, _ = jax.random.split(key)
    tkey, _ = prng.split(tkey)
    for _ in range(30):
        key, kg, ku, kc = jax.random.split(key, 4)
        tkey, tg, tu, tc = prng.split(tkey, 4)
        for j, t in ((key, tkey), (kg, tg), (ku, tu), (kc, tc)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax.random.key_data(j)))
        np.testing.assert_array_equal(
            prng.uniform(tu, (K, 7, 5), torch.float64).numpy(),
            np.asarray(jax.random.uniform(ku, (K, 7, 5), jnp.float64)))
        np.testing.assert_allclose(
            prng.normal(tg, (K, 2, 5), torch.float64).numpy(),
            np.asarray(jax.random.normal(kg, (K, 2, 5), jnp.float64)),
            rtol=0, atol=1e-14)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_snob_run_batch_matches_jax(regime):
    jopt, opt = _pair(regime, seed=6)
    x0 = jopt.init_points(K)
    opt.init_points(K)
    jk = jax.random.split(jax.random.key(1), K)
    tk = prng.split(prng.key(1), K)
    want = jopt._run_batch(jnp.asarray(x0), jk)
    got = opt._run_batch(torch.as_tensor(x0), tk)
    for name in ("x", "fid", "true_fid"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-9)
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(want.nfev))
    np.testing.assert_array_equal(got.nit.numpy(), np.zeros(K))
    bill = 300 * (4 if regime == "fixed" else 1)
    assert bool((got.nfev == bill).all())
    if regime == "fixed":
        assert torch.equal(got.fid, got.true_fid)
    assert opt.stats == {"rounds": 30, "syncs": 0}


@pytest.mark.parametrize("case", [
    dict(repeats=32, run_until_completion_its=9600, save_topc=10,
         restart_batch=16),
    dict(repeats=8, run_until_completion_its=10**7, save_topc=4,
         use_fixed_ham=True, opt_train_size=10, ham_noisy=True,
         restart_batch=4),
    dict(repeats=16, run_until_completion_its=3 * 8 * 330, save_topc=8,
         fid_noisy=True, adaptive=True, draws=10, restart_batch=8),
], ids=["flat", "fixed_ham", "adaptive"])
def test_snob_run_billing_matches_jax(case):
    """tests/test_models.py's billing cases (budget a restart; budget x
    train_size under fixed-ham) and the adaptive protocol's in-band
    counts: the records equal the JAX package's."""
    kw = dict(case, fid_threshold=0.0, run_until_told_to_stop=True,
              landscape_exploration=True, testing=True, seed=0)
    jopt = JSNOB(4, 0, 2, **kw)
    opt = SNOB(4, 0, 2, **kw, **F64)
    if opt.use_fixed_ham:
        base.carry_state(opt, jax.random.key_data(jopt._key),
                         np.asarray(jopt.randH), np.asarray(jopt.randH_test))
    want, got = jopt.run(), opt.run()
    assert got is not None and abs(got - want) < 1e-9
    for key in ("func_calls", "iterations", "repeats"):
        assert opt.record[key] == jopt.record[key], key
    np.testing.assert_allclose(np.sort(opt.record["controllers"], axis=0),
                               np.sort(jopt.record["controllers"], axis=0),
                               rtol=0, atol=1e-9)
    calls = opt.record["func_calls"]
    if case.get("use_fixed_ham"):
        assert calls % (300 * 10) == 0
    elif case.get("adaptive"):
        assert calls % 300 != 0 and calls > 300 * 8
    else:
        assert calls % 300 == 0
