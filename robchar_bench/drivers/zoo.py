"""The ``zoo`` driver: a restart pool of one optimizer family of the port's
zoo, run as a user runs it, through ``ControlOptimizer.run()``.

Set-up builds the optimizer once: the family the mix names, the
configuration's chain, float32 on the card, landscape exploration with a
top-c store of ``save_topc``, the mix's lane width, run until told to stop
with a function-call budget no pool reaches, and ``fid_threshold`` 0 so
that the pool's best is recorded.  The starts are the benchmark's: each
unit's pool is drawn from the seed and the unit's index (numpy, uniform in
the configuration's box, float32) and handed to the optimizer as its
start points.  A unit is one ``run()`` over one pool of ``pool`` restarts
(repeats = batch = pool), with the record copied out: the top-c
controllers, the best controller, its fidelity and the function calls.
Its work is the pool's restarts, and the gradient evaluations the run
billed (noiseless: two calls an evaluation, models/lbfgs.py).

The check works each unit's results out again with reference/physics.py
in float64: the fidelity of the recorded best controller against the
recorded fidelity (kernel 3's value at the returned point), and the best
of the pool's starts against the best returned controllers (the search
moved).  Kernel 2's own outputs are judged where the window produced them:
set-up wraps the gradient function that each ``run()`` builds
(``make_exact_gradient_batch`` of the program's objectives module, looked
up while ``run()`` builds its batch function, and put back at once) so
that one call in the mix's ``sample_every`` in the window, from an offset
drawn from the seed, keeps a reference to its points, infidelities and
gradients.  Nothing is copied in the window; the reference works each kept
call's 1024 lanes out again after it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from robchar_bench.drivers import Job
from robchar_bench.reference import physics

#: the index of the warm-up unit's starts (no unit of a window takes it)
WARM_UNIT = 2**32 - 1


def _box(cfg):
    n, box = cfg["n"], cfg["controller_box"]
    lo = np.array([box["bias"][0]] * n + [box["time"][0]])
    hi = np.array([box["bias"][1]] * n + [box["time"][1]])
    return lo, hi


def starts(cfg: Dict, seed: int, u: int, count: int) -> np.ndarray:
    """Unit ``u``'s pool of starts, float32 (count, n + 1)."""
    lo, hi = _box(cfg)
    rng = np.random.default_rng([int(seed), int(u)])
    return (lo + (hi - lo) * rng.random((count, lo.size))).astype(np.float32)


def setup(cfg: Dict, mix: Dict, seed: int, device) -> Job:
    models = importlib.import_module("code_robchar_tpu_torch.models")
    family = getattr(models, mix["family"])
    pool = mix["pool"]
    opt = family(cfg["n"], cfg["in_site"], cfg["out_site"],
                 bmin=cfg["controller_box"]["bias"][0],
                 bmax=cfg["controller_box"]["bias"][1],
                 max_time=cfg["controller_box"]["time"][1],
                 testing=True, seed=int(seed) & 0x7FFFFFFF,
                 fid_threshold=0.0, repeats=pool, restart_batch=pool,
                 run_until_told_to_stop=True,
                 run_until_completion_its=10**12,
                 landscape_exploration=True, save_topc=mix["save_topc"],
                 device=torch.device(device), dtype=torch.float32,
                 **mix.get("options", {}))
    pending: List[np.ndarray] = []
    # the benchmark's starts in place of the optimizer's own draw
    opt.init_points = lambda k: pending.pop()[:k]
    every = mix["sample_every"]
    kept: Dict = {"open": False, "calls": 0, "calls_kept": [],
                  "offset": int(seed) % every}
    objectives = importlib.import_module(
        "code_robchar_tpu_torch.models.objectives")
    build = opt._batch_fn

    def sampled(fn):
        def f(xs):
            errs, grads = fn(xs)
            if kept["open"] and \
                    kept["calls"] % every == kept["offset"]:
                kept["calls_kept"].append((xs, errs, grads))
            kept["calls"] += 1
            return errs, grads
        return f

    def observed_batch_fn():
        real = objectives.make_exact_gradient_batch
        objectives.make_exact_gradient_batch = lambda spec: sampled(real(spec))
        try:
            return build()
        finally:
            objectives.make_exact_gradient_batch = real

    opt._batch_fn = observed_batch_fn
    return Job({"seed": int(seed)},
               {"opt": opt, "pending": pending, "kept": kept})


def _run(job: Job, cfg: Dict, count: int, u: int) -> Dict:
    opt = job.program["opt"]
    opt.repeats = opt.restart_batch = count
    job.program["pending"].append(starts(cfg, job.inputs["seed"], u, count))
    opt.run()
    rec = opt.record
    return {"controllers": np.asarray(rec["controllers"], dtype=np.float64),
            "controller": np.asarray(rec["controller"], dtype=np.float64),
            "best_fid": float(rec["best_fid"]),
            "func_calls": int(rec["func_calls"]),
            "stats": dict(opt.stats), "u": u, "pool": count}


def unit(job: Job, cfg: Dict, mix: Dict, u: int) -> Dict:
    kept = job.program["kept"]
    kept["open"] = True
    try:
        out = _run(job, cfg, mix["pool"], u)
    finally:
        kept["open"] = False
    # the calls kept during this unit, handed to the check with it
    out["kernel2"] = kept["calls_kept"]
    kept["calls_kept"] = []
    return out


def warm(job: Job, cfg: Dict, mix: Dict) -> None:
    _run(job, cfg, mix["warm_pool"], WARM_UNIT)


def work(cfg: Dict, mix: Dict, out) -> Dict[str, float]:
    return {"restarts": float(out["pool"]),
            "grad_evals": out["func_calls"] / mix["calls_per_eval"]}


def valid(cfg: Dict, out) -> bool:
    c = out["controllers"]
    return (c.ndim == 2 and c.shape[1] == cfg["n"] + 1 and len(c) > 0
            and np.isfinite(c).all() and np.isfinite(out["best_fid"])
            and out["func_calls"] >= out["pool"])


def _top_mean(fids: np.ndarray, count: int) -> float:
    return float(np.sort(fids)[-count:].mean())




def readings(cfg: Dict, mix: Dict, inputs: Dict, outs: List[Dict],
             control: bool = False) -> Dict[str, float]:
    """best_gap: the widest gap, over units, between a unit's recorded best
    fidelity (``control``: the TF32 reference's at the same controller) and
    the float64 reference's at its controller.  unimproved: the mean over
    units of the ratio of the mean fidelity of the TOP best starts to that
    of the TOP best returned controllers (the reference's, float64): 1
    where the search left its starts where they were.  Over the kept calls
    of kernel 2 and their lanes, against the float64 reference at the same
    points (``control``: the TF32 reference's in the program's place):
    value_gap, the widest gap of an infidelity; grad_gap, the widest gap of
    a gradient component over the largest component of the reference's
    gradients in that call (the scale of the call's gradients)."""
    h0 = physics.xx_chain(cfg["n"])
    args = (cfg["in_site"], cfg["out_site"])
    top = mix["compare_top"]
    gap, ratios, value_gap, grad_gap, kept = 0.0, [], 0.0, 0.0, 0
    for out in outs:
        best = out["controller"][None]
        want = float(physics.controller_fidelity(h0, best, *args)[0])
        got = (float(physics.controller_fidelity(h0, best, *args,
                                                 precision="tf32")[0])
               if control else out["best_fid"])
        gap = max(gap, abs(got - want))
        pool = starts(cfg, inputs["seed"], out["u"], out["pool"])
        found = physics.controller_fidelity(h0, out["controllers"], *args)
        ratios.append(_top_mean(physics.controller_fidelity(h0, pool, *args),
                                top) / max(_top_mean(found, top), 1e-30))
        for xs, errs, grads in out["kernel2"]:
            xs = xs.double().cpu().numpy()
            want_e, want_g = physics.infidelity_and_gradient(h0, xs, *args)
            if control:
                got_e, got_g = physics.infidelity_and_gradient(
                    h0, xs, *args, precision="tf32")
            else:
                got_e = errs.double().cpu().numpy()
                got_g = grads.double().cpu().numpy()
            value_gap = max(value_gap, float(np.abs(got_e - want_e).max()))
            grad_gap = max(grad_gap, float(np.abs(got_g - want_g).max())
                           / max(float(np.abs(want_g).max()), 1e-30))
            kept += 1
    # a run that kept no call of kernel 2 has nothing to show for it
    none = float("inf")
    return {"best_gap": gap, "unimproved": float(np.mean(ratios)),
            "value_gap": value_gap if kept else none,
            "grad_gap": grad_gap if kept else none}
