"""The port's optimizer zoo slice against outcomes: the KS gates of
tests/test_models.py against the frozen scipy outcome distributions, at
f32 on the CPU, and ``run()`` in threshold and budget mode against the
JAX package's record (per-restart parity is in tests/test_torch_zoo.py).
"""

import json
import os

import numpy as np
import pytest
import scipy.stats
import torch

from code_robchar_tpu.models import LBFGS as JLBFGS, NMPlus as JNMPlus
from code_robchar_tpu_torch.models import LBFGS, NMPlus
from code_robchar_tpu_torch.ops import prng

F64 = dict(dtype=torch.float64, device="cpu")
ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jcls, cls, n=4, out=2, **kw):
    return (jcls(n, 0, out, testing=True, **kw),
            cls(n, 0, out, testing=True, **kw, **F64))


@pytest.mark.parametrize("cls,jcls", [(LBFGS, JLBFGS), (NMPlus, JNMPlus)])
@pytest.mark.parametrize("n", [4, 5])
def test_outcome_distribution_matches_scipy_f32(cls, jcls, n):
    """The KS gates of tests/test_models.py at f32 on the CPU: 512
    restarts against the frozen scipy distributions, and the NM budget
    currency (mean nfev within 15 of the artifact's)."""
    name = "lbfgs" if cls is LBFGS else "nm"
    with open(os.path.join(ARTIFACTS, f"scipy_{name}_dist.json")) as f:
        art = json.load(f)[f"{n}_2"]
    opt = cls(n, 0, 2, testing=True, seed=7, dtype=torch.float32,
              device="cpu")
    x0s = torch.as_tensor(opt.init_points(512), dtype=torch.float32)
    res = opt._run_batch(x0s, prng.split(prng.key(0), 512))
    stat, p = scipy.stats.ks_2samp(res.fid.numpy(), np.asarray(art["fids"]))
    assert stat < 0.12, f"N={n} {name}: KS {stat:.3f} (p={p:.3f})"
    if cls is NMPlus:
        assert abs(float(res.nfev.double().mean()) - art["mean_nfev"]) < 15


def _records_agree(jopt, opt):
    for k in ("func_calls", "iterations", "repeats"):
        assert opt.record[k] == jopt.record[k], k
    assert abs(opt.record["best_fid"] - jopt.record["best_fid"]) < 1e-8
    np.testing.assert_allclose(opt.record["controller"],
                               jopt.record["controller"], rtol=0, atol=1e-8)


def test_run_threshold_mode_matches_jax():
    jopt, opt = _pair(JNMPlus, NMPlus, repeats=96, fid_threshold=0.95,
                      restart_batch=32, lane_width=16)
    want, got = jopt.run(), opt.run()
    assert want is not None and abs(got - want) < 1e-8
    _records_agree(jopt, opt)


def test_run_budget_mode_matches_jax():
    kw = dict(repeats=10**9, fid_threshold=0.0, run_until_told_to_stop=True,
              run_until_completion_its=1500, landscape_exploration=True,
              save_topc=16, records_update_rate=400, restart_batch=32,
              lane_width=16, maxiter=3)
    jopt, opt = _pair(JLBFGS, LBFGS, **kw)
    want, got = jopt.run(), opt.run()
    assert abs(got - want) < 1e-8
    _records_agree(jopt, opt)
    assert opt.record["func_calls"] + 1 >= 1500
    np.testing.assert_allclose(np.sort(opt.record["controllers"], axis=0),
                               np.sort(jopt.record["controllers"], axis=0),
                               rtol=0, atol=1e-8)
    assert sorted(opt.records) == sorted(jopt.records)
