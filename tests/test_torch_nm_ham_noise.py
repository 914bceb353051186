"""Nelder-Mead under ham noise in the pipeline's collect, through both
packages: the port's Experiment (float32 on the CPU) and the JAX package's
(float32: jax_enable_x64 off, so in a process of its own), from the same
seed, at the collect's configuration (N=7, 0 -> 6, ham_noisy, sigma 0.05,
fid_threshold 0.0, 1000 stored controllers, landscape exploration) with
its 100,000-call budget cut to BUDGET.

Both packages split the budget over the same restart starts, and both
store controllers whose best noiseless fidelity lies near the starts'
(under 0.2; at the whole budget sometimes below the best start's), far
from what the noiseless objective reaches with the same budget: the noisy
objective's estimate, not the port, holds the search there.  What both
do hold is that the search leaves its starts: most stored controllers
are points the simplices moved to, not starts (the gate of
``chip_smoke.py``'s collect for Nelder-Mead under ham noise).  Both
packages draw a run's seed from numpy's global generator (a model built
with no seed), so each side seeds that generator with SEED first.  Run
with ``-s`` to print the numbers; with BUDGET =
100_000 and NOISES = (0.0, 0.05, 0.1) this is the comparison with the
collect's whole budget."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.exp.experiment import Experiment
from code_robchar_tpu_torch.models import NMPlus, objectives
from code_robchar_tpu_torch.ops import chain

BUDGET = 10_000
NOISES = (0.05,)
SEED = 0
N, OUT = 7, 6
#: a store near the starts: far below the ~0.93 that both packages reach
#: with no noise at the whole budget
NEAR_STARTS = 0.2

_ARGS = dict(Nspin=N, inspin=0, outspin=OUT, fid_threshold=0.0,
             fid_noisy=False, ham_noisy=True, respawn_from_checkpoint=False,
             verbose=False, run_until_told_to_stop=True, runs=1000)

#: the JAX package's run, in a process of its own (float32)
_JAX = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
from code_robchar_tpu.exp.experiment import Experiment
from code_robchar_tpu.models import NMPlus
args, noises, budget, seed = json.loads(sys.argv[1])
np.random.seed(seed)
starts = {}
orig = NMPlus._run_batch
def rec(self, x0s, *a, **k):
    starts.setdefault(str(self.noise), []).append(
        np.asarray(x0s, dtype=np.float64).tolist())
    return orig(self, x0s, *a, **k)
NMPlus._run_batch = rec
exp = Experiment("nm_ham_noise", noises=np.asarray(noises),
                 run_until_completion_its=budget, **args)
exp.singlerun_ccollector(model_choices=["nmplus"])
print(json.dumps({"store": exp.filename, "starts": starts}))
"""


def _fids(xs):
    h0 = chain.xx_hamiltonian_real(N, dtype=torch.float64, device="cpu")
    return objectives.fidelity_batch(
        h0, torch.as_tensor(np.asarray(xs, dtype=np.float64).reshape(
            -1, N + 1)), 0, OUT).numpy()


def share_of_starts(stored, starts, tol=1e-6):
    """The share of the stored controllers that are (within ``tol``) one
    of the starts."""
    stored = np.asarray(stored, dtype=np.float64).reshape(len(stored), -1)
    starts = np.asarray(starts, dtype=np.float64)
    dist = np.abs(stored[:, None, :] - starts[None, :, :]).max(-1).min(1)
    return float((dist <= tol).mean())


def _summary(store_path, starts):
    with open(store_path) as f:
        store = json.load(f)["nmplus"]
    out = {}
    for noise, batches in starts.items():
        kept = _fids(store[noise]["controller"])
        out[noise] = dict(batches=[len(b) for b in batches],
                          at_starts=share_of_starts(
                              store[noise]["controller"],
                              np.concatenate(batches)),
                          first=np.asarray(batches[0]),
                          best_start=float(max(_fids(b).max()
                                               for b in batches)),
                          stored=len(kept), best=float(kept.max()),
                          median=float(np.median(kept)))
    return out


def _port(tmp_path, monkeypatch):
    starts = {}
    orig = NMPlus._run_batch

    def rec(self, x0s, *a, **k):
        starts.setdefault(str(self.noise), []).append(
            np.asarray(x0s, dtype=np.float64))
        return orig(self, x0s, *a, **k)

    monkeypatch.setattr(NMPlus, "_run_batch", rec)
    monkeypatch.chdir(tmp_path / "port")
    state = np.random.get_state()
    np.random.seed(SEED)
    try:
        exp = Experiment("nm_ham_noise", noises=np.asarray(NOISES),
                         run_until_completion_its=BUDGET, device="cpu",
                         **_ARGS)
        exp.singlerun_ccollector(model_choices=["nmplus"])
    finally:
        np.random.set_state(state)
    return _summary(exp.filename, starts)


def _jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX,
         json.dumps([_ARGS, NOISES, BUDGET, SEED])],
        cwd=tmp_path / "jax", env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return _summary(os.path.join(tmp_path / "jax", out["store"]),
                    out["starts"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_nm_under_ham_noise_stays_near_its_starts_in_both_packages(
        tmp_path, monkeypatch):
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
    port, jax = _port(tmp_path, monkeypatch), _jax(tmp_path)
    assert sorted(port) == sorted(jax) == [str(n) for n in NOISES]
    for noise in port:
        p, j = port[noise], jax[noise]
        print(f"\nNM N={N} 0->{OUT}, ham_noisy sigma {noise}, budget "
              f"{BUDGET}, float32: restarts a batch port {p['batches']} / "
              f"JAX {j['batches']}; best start {p['best_start']:.6f} / "
              f"{j['best_start']:.6f}; stored {p['stored']} / "
              f"{j['stored']}, best {p['best']:.6f} / {j['best']:.6f}, "
              f"median {p['median']:.3e} / {j['median']:.3e}; share of "
              f"the stored that are starts {p['at_starts']:.3f} / "
              f"{j['at_starts']:.3f}")
        # the same starts: the first batch's Sobol points
        np.testing.assert_array_equal(p["first"], j["first"])
        for r in (p, j):
            assert r["stored"] > 0 and r["at_starts"] < 0.5
            if float(noise) > 0:
                assert r["best"] < NEAR_STARTS
