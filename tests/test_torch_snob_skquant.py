"""The port's exact-SNOBFIT path (code_robchar_tpu_torch/models/
snobfit_core.py, the vendored engine, and models/snob_skquant.py, the
adapter) against the JAX package's, on the CPU.

The engine draws from an unseeded ``np.random.default_rng()`` inside
``minimize`` (both packages; the adapter passes no generator), so the
tests seed both sides the same way: ``np.random.default_rng`` is patched
for the test to return a generator of one fixed seed.  Every call of the
engine runs under a cap on ``SnobFit.suggest`` calls: ``minimize`` loops
on ``suggest`` and would spin forever on an empty batch (a fault of the
reference side that the port inherits).

- The engine: the problems of tests/test_snobfit_core.py, suggested
  batches and whole histories identical under the same generator.
- The adapter at N=4, float64, noiseless and ham-noisy: every scored
  batch's points equal and its values within 1e-10 of the JAX package's
  (one ``next_key()`` a scored batch, in the JAX package's order), the
  restarts' histories and the run's record (best_fid, func_calls,
  controllers, the top-c store) within 1e-10; its refusals.
"""

import numpy as np
import pytest
import torch

from code_robchar_tpu.models import snob_skquant as jsq
from code_robchar_tpu.models import snobfit_core as jsc
from code_robchar_tpu_torch.models import MODEL_REGISTRY, SNOBSkquant
from code_robchar_tpu_torch.models import snob_skquant as psq
from code_robchar_tpu_torch.models import snobfit_core as psc

TOL = 1e-10
SUGGEST_CAP = 2000


@pytest.fixture(autouse=True)
def _capped(monkeypatch):
    """One torch thread, and a cap on suggest() calls in both engines."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (jsc, psc):
        calls = [0]

        def capped(self, k, _orig=mod.SnobFit.suggest, _calls=calls):
            _calls[0] += 1
            if _calls[0] > SUGGEST_CAP:
                raise RuntimeError("suggest() call cap reached")
            return _orig(self, k)
        monkeypatch.setattr(mod.SnobFit, "suggest", capped)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def seeded(monkeypatch):
    """``np.random.default_rng()`` without a seed returns a generator of
    the given seed, in both engines (they share numpy)."""
    orig = np.random.default_rng

    def seed(s):
        monkeypatch.setattr(np.random, "default_rng",
                            lambda *a, **k: orig(*(a or (s,)), **k))
    return seed


def _quadratic(x):
    return float(np.sum((x - 0.3) ** 2))


def _rastrigin(x):
    return float(10 * len(x) + np.sum(x * x - 10 * np.cos(2 * np.pi * x)))


def _wave(x):
    return float(np.cos(3 * x[0]) + x[1] ** 2)


PROBLEMS = {
    "quadratic": (_quadratic, np.zeros(5), [[-2.0, 2.0]] * 5, 300, {}),
    "rastrigin": (_rastrigin, np.full(4, 1.7), [[-5.12, 5.12]] * 4, 300,
                  {}),
    "wave": (_wave, np.zeros(2), [[-3, 3], [-3, 3]], 40,
             {"maxfail": 10 ** 9}),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("batched", [False, True])
def test_engine_histories_identical(name, batched):
    f, x0, bounds, budget, opt = PROBLEMS[name]
    out = []
    for sc in (jsc, psc):
        kw = dict(budget=budget, options=sc.optset(optin=opt),
                  rng=np.random.default_rng(3))
        if batched:
            kw["objective_batch"] = lambda xs: np.asarray([f(x) for x in xs])
        out.append(sc.minimize(f, x0, bounds, **kw))
    (jr, jh), (pr, ph) = out
    assert ph.shape == jh.shape and len(ph) <= budget
    np.testing.assert_array_equal(ph, jh)
    assert pr.optval == jr.optval
    np.testing.assert_array_equal(pr.optpar, jr.optpar)


def test_engine_suggested_batches_identical():
    rng = np.random.default_rng(5)
    told = [(x, _rastrigin(x)) for x in rng.uniform(-5, 5, (30, 4))]
    fits = []
    for sc in (jsc, psc):
        sf = sc.SnobFit([[-5.12, 5.12]] * 4, maxmp=150,
                        rng=np.random.default_rng(8))
        batches = []
        for x, fx in told[:10]:
            sf.tell(x, fx)
        for x, fx in told[10:]:
            batches.append(sf.suggest(10))
            sf.tell(x, fx)
        fits.append((batches, sf.best()))
    for pb, jb in zip(fits[1][0], fits[0][0]):
        np.testing.assert_array_equal(pb, jb)
    assert fits[1][1][1] == fits[0][1][1]


def test_engine_surface_is_the_reference_one():
    o = psc.optset(optin={"maxmp": 77, "maxfail": 5, "verbose": True,
                          "custom": 1})
    assert o.maxmp == 77 and o.maxfail == 5 and o.extra == {"custom": 1}
    with pytest.raises(ValueError, match="snobfit"):
        psc.minimize(_wave, np.zeros(2), [[-1, 1]] * 2, method="imfil")


class _Recorder:
    """A stand-in for the engine's namespace that keeps every restart's
    history and every scored batch (points, values).  With ``forced`` (the
    JAX run's batches) the engine is fed the JAX package's values in place
    of the port's own, which are kept for the comparison."""

    def __init__(self, engine, forced=None):
        self.engine, self.forced = engine, forced
        self.histories, self.batches = [], []

    def minimize(self, objective, x0, objective_batch=None, **kw):
        def scored(xs):
            vals = np.asarray(objective_batch(xs), dtype=float)
            self.batches.append((np.array(xs), vals))
            if self.forced is not None:
                return self.forced[len(self.batches) - 1][1]
            return vals
        res, hist = self.engine.minimize(objective, x0,
                                         objective_batch=scored, **kw)
        self.histories.append(hist)
        return res, hist


RUN = dict(testing=True, seed=3, fid_threshold=0.0,
           run_until_told_to_stop=True, landscape_exploration=True,
           save_topc=20, noise=0.05)


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy"])
def test_adapter_run_matches_jax(seeded, regime):
    """SNOBFIT's discrete choices (box splits, the fits' neighbours)
    amplify rounding-level differences of the objective (~1e-13 between
    the packages' float64 Jacobi orders) into other trajectories, as
    whole zoo runs part.  So the port's engine is fed the JAX run's values
    while the port's own value of every scored batch is held within 1e-10
    of the JAX package's for the same points: under ham noise a batch
    scored under another key than the JAX package's would miss by far
    more.  The points suggested, the histories and the record then follow
    from the port's adapter alone."""
    seeded(123)
    kw = dict(RUN, ham_noisy=regime == "ham_noisy",
              run_until_completion_its=3 * 300)
    j = jsq.SNOBSkquant(4, 0, 2, backend="vendored", **kw)
    p = SNOBSkquant(4, 0, 2, backend="vendored", device="cpu",
                    dtype=torch.float64, **kw)
    assert j.backend_name == p.backend_name == "vendored"
    j._skq = _Recorder(j._skq)
    jbest = j.run()
    p._skq = _Recorder(p._skq, forced=j._skq.batches)
    pbest = p.run()
    assert len(p._skq.batches) == len(j._skq.batches) > 3 * 10
    for (px, pv), (jx, jv) in zip(p._skq.batches, j._skq.batches):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(pv, jv, atol=TOL, rtol=0)
    assert [len(x) for x, _ in p._skq.batches[:2]] == [1, 4 + 1 + 6]
    assert len(p._skq.histories) == len(j._skq.histories) == 3
    for ph, jh in zip(p._skq.histories, j._skq.histories):
        np.testing.assert_array_equal(ph, jh)
    assert abs(pbest - jbest) < TOL
    assert p.record["func_calls"] == j.record["func_calls"] == 900
    assert p.record["repeats"] == j.record["repeats"]
    for name in ("best_fid", "controller", "controllers"):
        np.testing.assert_allclose(p.record[name], j.record[name], atol=TOL,
                                   rtol=0, err_msg=name)
    # the key streams advanced alike: one next_key() a scored batch
    np.testing.assert_array_equal(
        p.next_key().numpy(),
        np.asarray(__import__("jax").random.key_data(j.next_key())))


def test_adapter_threshold_mode_matches_jax(seeded):
    """The first-hit mode from uniform starts (one ``next_key()`` a start,
    then one a scored batch), the engine fed as above."""
    seeded(7)
    kw = dict(testing=True, seed=1, fid_threshold=0.5, repeats=4,
              ham_noisy=True)
    j = jsq.SNOBSkquant(4, 0, 2, backend="vendored", **kw)
    p = SNOBSkquant(4, 0, 2, backend="vendored", device="cpu",
                    dtype=torch.float64, **kw)
    j._skq = _Recorder(j._skq)
    jf = j.run()
    p._skq = _Recorder(p._skq, forced=j._skq.batches)
    pf = p.run()
    assert jf is not None and jf > 0.5 and abs(pf - jf) < TOL
    assert len(p._skq.batches) == len(j._skq.batches)
    for (px, pv), (jx, jv) in zip(p._skq.batches, j._skq.batches):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(pv, jv, atol=TOL, rtol=0)
    assert p.record["func_calls"] == j.record["func_calls"]
    for name in ("best_fid", "controller"):
        np.testing.assert_allclose(p.record[name], j.record[name], atol=TOL,
                                   rtol=0, err_msg=name)


def test_adapter_refusals_and_registry():
    assert psq._load_backend("vendored")[2] == "vendored"
    assert psq._load_backend("auto")[2] == jsq._load_backend("auto")[2]
    with pytest.raises(ImportError, match="skquant"):
        SNOBSkquant(4, 0, 2, backend="skquant", device="cpu")
    with pytest.raises(ImportError):
        jsq.SNOBSkquant(4, 0, 2, backend="skquant")
    with pytest.raises(NotImplementedError, match="adaptive"):
        SNOBSkquant(4, 0, 2, adaptive=True, fid_noisy=True, device="cpu")
    with pytest.raises(NotImplementedError, match="adaptive"):
        jsq.SNOBSkquant(4, 0, 2, adaptive=True, fid_noisy=True)
    assert SNOBSkquant not in MODEL_REGISTRY.values()
    assert SNOBSkquant.name == "snob"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SNOBSkquant(4, 0, 2, backend="vendored")
