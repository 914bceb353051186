"""The ``nm`` driver: a multi-start Nelder-Mead restart pool of the port's
``NMPlus``, run as a user runs it, through ``ControlOptimizer.run()``.

Set-up builds the optimizer once, as drivers/zoo.py builds its family: the
configuration's chain, float32 on the card, landscape exploration with a
top-c store of ``save_topc``, the mix's options (lane width, the
evaluation budget of a restart), run until told to stop with a
function-call budget no pool reaches, and ``fid_threshold`` 0 so that the
pool's best is recorded.  The starts are the benchmark's (``zoo.starts``:
uniform in the configuration's box from the seed and the unit's index),
handed to the optimizer as its start points.  A unit is one ``run()``
over one pool of ``pool`` restarts, with the record copied out
(``zoo._run``).  Its work is the pool's restarts, the evaluations the run
billed (noiseless: one call an evaluation, models/nmplus.py), and the
round loop's rounds and host syncs (its ``stats``).

The check works each unit's results out again with reference/physics.py
in float64: the fidelity of the recorded best controller against the
recorded fidelity, and the best of the pool's starts against the best
returned controllers (the search moved), as drivers/zoo.py does; and every
restart of the pool, the point ``_run_batch`` returned for it against its
start (each restart moved).  Set-up wraps ``NMPlus._run_batch``, and a
unit keeps a reference to the batch result it returns.  Kernel 3's own
outputs are judged where the window produced them: ``_run_batch`` looks
``make_infidelity_batch`` up in the program's objectives module each time
it runs, so the wrapper puts a sampling wrapper in that place for the one
lookup, and the real builder back at once.  One call of the built
objective in the mix's ``sample_every`` in the window, from an offset
drawn from the seed, keeps a reference to its points and infidelities: the
round loop's batch of lanes x 9 points, or the final re-evaluation.
Nothing is copied in the window; the reference works every restart and
every slot of each kept call out again after it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from robchar_bench.drivers import Job, zoo
from robchar_bench.drivers.zoo import WARM_UNIT, _run, starts
from robchar_bench.reference import physics

#: a unit's outputs are checked for shape and finiteness as the zoo's are
valid = zoo.valid

#: ``unmoved`` judges the restarts whose start has a reference fidelity of
#: this many steps of the configuration's precision below 1 (float32:
#: 16 x 2**-24, 9.5e-07) or more.  Under it every vertex of a start's
#: first simplex may read the same 1 - F, and NM rightly shrinks back onto
#: its start (a fifth to a quarter of the cell's uniform starts).
RESOLVED_ULPS = 16


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
                  "batches": [], "offset": int(seed) % every}
    objectives = importlib.import_module(
        "code_robchar_tpu_torch.models.objectives")
    run_batch = opt._run_batch

    def sampled(fn):
        def f(xs, key):
            errs, calls = fn(xs, key)
            if kept["open"] and \
                    kept["calls"] % every == kept["offset"]:
                kept["calls_kept"].append((xs, errs))
            kept["calls"] += 1
            return errs, calls
        return f

    def observed_run_batch(x0s, keys):
        real = objectives.make_infidelity_batch

        def once(spec):
            objectives.make_infidelity_batch = real
            return sampled(real(spec))

        objectives.make_infidelity_batch = once
        try:
            res = run_batch(x0s, keys)
        finally:
            objectives.make_infidelity_batch = real
        if kept["open"]:
            kept["batches"].append(res)
        return res

    opt._run_batch = observed_run_batch
    return Job({"seed": int(seed)},
               {"opt": opt, "pending": pending, "kept": kept})


def unit(job: Job, cfg: Dict, mix: Dict, u: int) -> Dict:
    kept = job.program["kept"]
    kept["open"] = True
    try:
        out = _run(job, cfg, mix["pool"], u)
    finally:
        kept["open"] = False
    # the calls and batch results kept during this unit, handed to the
    # check with it
    out["kernel3"], out["batches"] = kept["calls_kept"], kept["batches"]
    kept["calls_kept"], kept["batches"] = [], []
    return out


def warm(job: Job, cfg: Dict, mix: Dict) -> None:
    _run(job, cfg, mix["warm_pool"], WARM_UNIT)


def work(cfg: Dict, mix: Dict, out) -> Dict[str, float]:
    return {"restarts": float(out["pool"]),
            "evals": out["func_calls"] / mix["calls_per_eval"],
            "rounds": float(out["stats"].get("rounds", 0)),
            "syncs": float(out["stats"].get("syncs", 0))}


def _unmoved(h0, args, floor: float, x0s: np.ndarray, out: Dict) -> float:
    """The share of the unit's resolved restarts (start fidelity >= floor)
    whose returned point reads no higher than their start; 1 where the
    batches returned fewer points than the pool has restarts."""
    xs = [r.x.double().cpu().numpy() for r in out["batches"]]
    if sum(map(len, xs)) < len(x0s):
        return 1.0
    xs = np.concatenate(xs)[:len(x0s)]
    f0 = physics.controller_fidelity(h0, x0s, *args)
    live = f0 >= floor
    moved = physics.controller_fidelity(h0, xs[live], *args) > f0[live]
    return 1.0 - float(moved.mean())


def readings(cfg: Dict, mix: Dict, inputs: Dict, outs: List[Dict],
             control: bool = False) -> Dict[str, float]:
    """best_gap and unimproved: drivers/zoo.py's (the recorded best fidelity
    against the float64 reference's at its controller; the best starts
    against the best returned controllers).  unmoved: the largest share,
    over units, of the restarts whose returned point has a float64
    reference fidelity no higher than their start's, among those whose
    start reads RESOLVED_ULPS steps below 1 or more: NM keeps its start in
    the simplex, so a restart that searched reads above it; 1 where the
    pool came back as it went in.  The control re-runs no search, so it
    reads the program's points there.  value_gap: the widest gap, over the
    kept calls of kernel 3 and every slot of each, between the program's
    infidelity (``control``: the TF32 reference's) and the float64
    reference's at the same point."""
    out = zoo.readings(cfg, mix, inputs, [{**o, "kernel2": []} for o in outs],
                       control)
    h0 = physics.xx_chain(cfg["n"])
    args = (cfg["in_site"], cfg["out_site"])
    floor = RESOLVED_ULPS * float(np.finfo(cfg["dtype"]).epsneg)
    unmoved, value_gap, kept = 0.0, 0.0, 0
    for o in outs:
        x0s = starts(cfg, inputs["seed"], o["u"], o["pool"])
        unmoved = max(unmoved, _unmoved(h0, args, floor, x0s, o))
        for xs, errs in o["kernel3"]:
            xs = xs.double().cpu().numpy()
            want_e = 1.0 - physics.controller_fidelity(h0, xs, *args)
            got_e = (1.0 - physics.controller_fidelity(
                h0, xs, *args, precision="tf32") if control
                else errs.double().cpu().numpy())
            value_gap = max(value_gap, float(np.abs(got_e - want_e).max()))
            kept += 1
    # a run that kept no call of kernel 3 has nothing to show for it
    return {"best_gap": out["best_gap"], "unimproved": out["unimproved"],
            "unmoved": unmoved,
            "value_gap": value_gap if kept else float("inf")}
