"""Exact-SNOBFIT adapter (counterpart of
code_robchar_tpu/models/snob_skquant.py; outside ``MODEL_REGISTRY``).

The registry's ``models.snob.SNOB`` is a budget-matched surrogate of the
reference's SNOBFIT restarts.  This adapter runs the reference's exact
search instead: one host-side ``minimize(method="snobfit")`` call per
Sobol restart, mirroring qnewton.py:818-835 with ``optset(maxmp=150,
maxfail=100)`` (qnewton.py:823-827) and ``budget=300``, with the
reference's record, top-c and fcall semantics (qnewton.py:862-928).

The engine comes from ``_load_backend``: the reference's skquant stack
when it is installed, else the vendored implementation of the published
algorithm (models/snobfit_core.py, Huyer & Neumaier 2008).
``backend="skquant"`` asks for the reference stack and raises ImportError
when it is absent.

SNOBFIT's branch-and-fit search is host numpy and sequential by nature.
On the vendored backend each suggested batch (n + 6 points, and the
restart's start alone) is scored in one call of
``objectives.make_infidelity_batch`` with one ``next_key()`` a batch: the
lane-group amplitude kernel on the card.  The noiseless re-evaluation of
each restart's optimum (``fidelity_ss``) is one more launch.  Like the
JAX package's, the vendored engine draws from an unseeded
``np.random.default_rng()``, so a run does not repeat.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.models.base import ControlOptimizer
from code_robchar_tpu_torch.utils.record import RunRecord, TopControllers


def _load_backend(backend: str = "auto"):
    """Resolve the SNOBFIT engine.

    - "skquant": the reference's own stack (skquant + SQSnobFit); raises
      ImportError when absent.
    - "vendored": models/snobfit_core.py, the implementation of the
      published branch-and-fit algorithm, always available.
    - "auto": skquant when installed, else vendored.

    Returns (namespace-with-minimize, optset, resolved_name)."""
    if backend in ("auto", "skquant"):
        try:
            from skquant import opt as skq      # noqa: F401
            from SQSnobFit import optset        # noqa: F401
            return skq, optset, "skquant"
        except ImportError as e:
            if backend == "skquant":
                raise ImportError(
                    "backend='skquant' requires the reference's optimizer "
                    "stack: pip install skquant SQSnobFit.  Use "
                    "backend='vendored' (published-algorithm "
                    "implementation, models/snobfit_core.py) or the "
                    "budget-matched surrogate models.SNOB.") from e
    from code_robchar_tpu_torch.models import snobfit_core
    return snobfit_core, snobfit_core.optset, "vendored"


class SNOBSkquant(ControlOptimizer):
    """Reference-exact SNOBFIT restarts (qnewton.py:770-928).

    The surrogate ``SNOB``'s constructor surface (the base's keywords and
    ``budget``), its record protocol and its fcall accounting (300
    objective calls a restart, x train_size under fixed-ham,
    qnewton.py:862-866)."""

    name = "snob"           # writes reference-named record files

    def __init__(self, *args, budget: int = 300, backend: str = "auto",
                 **kwargs):
        self._skq, self._optset, self.backend_name = _load_backend(backend)
        super().__init__(*args, **kwargs)
        self.budget = int(budget)
        if self.adaptive:
            raise NotImplementedError(
                "adaptive-shot billing is not wired for the skquant "
                "adapter (the paper pipeline never runs snob adaptive); "
                "use models.SNOB or adaptive=False")

    def run(self):
        """The reference SNOB.run control flow (qnewton.py:775-928):
        Sobol or uniform x0 a restart, SNOBFIT minimize, top-c update,
        first hit or budget stop, wall-clock AssertionError timeout."""
        skq, optset = self._skq, self._optset
        rr = RunRecord(landscape_exploration=self.landscape_exploration,
                       records_update_rate=self.records_update_rate,
                       run_until_completion_its=self.run_until_completion_its)
        self.record = rr.record
        self.records = rr.records
        top = TopControllers(self.save_topc)
        funccalls = 0
        start = rr.start_time

        def infidelity(x):
            if self.use_fixed_ham:
                return 1.0 - self.fidelity_ss_av(x)
            return 1.0 - self.fidelity_ss(x, noisy=self.fid_noisy,
                                          ham_noisy=self.ham_noisy)

        extra_kw = {}
        if self.backend_name == "vendored":
            # the vendored engine scores a suggested batch in one call
            # (snobfit_core.minimize): one lanes batch, its draws folded
            # from the batch's key with the lane index
            infid_b = objectives.make_infidelity_batch(self.spec())

            def objective_batch(xs):
                vals, _bills = infid_b(
                    torch.as_tensor(np.asarray(xs), dtype=self.dtype,
                                    device=self.device), self.next_key())
                return vals.cpu().numpy().astype(float)

            extra_kw["objective_batch"] = objective_batch

        options = optset(optin={"maxmp": 150, "maxfail": 100,
                                "verbose": False})
        for rep in range(self.repeats):
            x0 = np.asarray(self.init_points(1)[0], dtype=float)
            result, _history = skq.minimize(
                infidelity, x0, bounds=np.asarray(self.val_bounds,
                                                  dtype=float),
                budget=self.budget, method="snobfit", options=options,
                **extra_kw)
            fi = 1.0 - float(result.optval)
            x = np.asarray(result.optpar, dtype=float)

            # the reported optimum is the min of the noisy history; the
            # noiseless re-evaluation feeds best_fid under noise
            # (qnewton.py:841-848, 886-889)
            true_fid = fi if self.use_fixed_ham else self.fidelity_ss(x)
            funccalls += self.budget * (self.train_size
                                        if self.use_fixed_ham else 1)

            def save_aux():
                rr.save(func_calls=funccalls, iterations=None,
                        repeats=rep, controller=x.tolist(),
                        best_fid=(true_fid if (self.ham_noisy or
                                               self.fid_noisy) else fi),
                        top=top if self.landscape_exploration else None)

            if not self.run_until_told_to_stop:
                if fi > self.fid_threshold:
                    save_aux()
                    if self.save:
                        self.save_record()
                    return fi
                if time.time() - start > self.timeout:
                    print(f"timed out! {self.filename}")
                    raise AssertionError("timeout")
                continue

            crit = (fi >= self.fid_threshold
                    if rr.record["best_fid"] is None
                    else (True if self.landscape_exploration
                          else fi >= rr.record["best_fid"]))
            if crit:
                if self.landscape_exploration:
                    top.offer(fi, x.tolist())
                save_aux()
            # the budget gate on this restart's billing (base.run returns
            # as soon as the billing crosses it); no budget runs on the
            # wall-clock timeout alone
            completion = (funccalls + 1 >=
                          (self.run_until_completion_its or np.inf))
            if completion:
                return rr.record["best_fid"]
            if time.time() - start > self.timeout:
                print(f"timed out! {self.filename}")
                raise AssertionError("timeout")
        return rr.record["best_fid"]
