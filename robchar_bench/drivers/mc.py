"""The ``mc`` driver: robustness characterisation of a controller set by the
port's fused Monte-Carlo sweep.

Set-up draws the cell's controllers from the seed (numpy; biases and times
uniform in the configuration's box, in float64, then cast to the
configuration's ``dtype``) and uploads them with the noise levels and the
drift, in that dtype.  A unit is one ``mc.engine.characterise(...,
return_fids=False)`` over every noise level x controller x bootstrap rep
of the configuration, keyed by fold_in(key(seed), unit), with the metric
tensors copied to the host: a user's characterisation of one controller
set.  Its work is the count of Hamiltonians.

The check draws a sample of (unit, noise level, controller) cells from the
seed and works each out again with reference/mc.py: the draws, the
assembly, the fidelities and the 15 metric values.  The readings are the
widest gaps of the program's values from the reference's, by metric
family.  The reference draws in the configuration's dtype and computes in
float64; the control is the reference computed one precision below the
configuration's (``CONTROLS``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from robchar_bench.drivers import Job
from robchar_bench.reference import mc as ref
from robchar_bench.reference import threefry

#: the metric families whose widest gaps are compared
FAMILIES = {"rim_gap": ref.RIM, "std_gap": "std",
            "worst_gap": "worst case fid"}
#: the quantile yields, compared by the share of values that moved
Q_PREFIX = "Q th."
#: the key of the warm-up unit (no unit of a window takes it)
WARM_UNIT = 2**32 - 1
#: the control of each configuration dtype: the reference in the precision
#: just below it (reference/physics.py)
CONTROLS = {"float32": "tf32", "float64": "float32"}


def inputs(cfg: Dict, mix: Dict, seed: int) -> Dict:
    """The cell's inputs, made from the seed alone."""
    n, box = cfg["n"], cfg["controller_box"]
    count = cfg["mc"]["controllers"]
    rng = np.random.default_rng(seed)
    ctrl = np.column_stack([rng.uniform(*box["bias"], (count, n)),
                            rng.uniform(*box["time"], count)])
    dtype = np.dtype(cfg["dtype"])
    return {"controllers": ctrl.astype(dtype),
            "noises": np.asarray(cfg["mc"]["noise_levels"], dtype),
            "seed": int(seed)}


def setup(cfg: Dict, mix: Dict, seed: int, device) -> Job:
    from code_robchar_tpu_torch.ops import chain

    inp = inputs(cfg, mix, seed)
    device = torch.device(device)
    program = {
        "device": device,
        "h0": chain.xx_hamiltonian_real(
            cfg["n"], dtype=getattr(torch, cfg["dtype"]), device=device),
        "controllers": torch.as_tensor(inp["controllers"], device=device),
        "noises": torch.as_tensor(inp["noises"], device=device),
    }
    return Job(inp, program)


def unit(job: Job, cfg: Dict, mix: Dict, u: int) -> Dict[str, np.ndarray]:
    from code_robchar_tpu_torch.mc import engine
    from code_robchar_tpu_torch.ops import prng

    p, mc = job.program, cfg["mc"]
    key = prng.fold_in(prng.key(job.inputs["seed"]), u)
    out = engine.characterise(
        p["h0"], p["controllers"], p["noises"], key, mc["bootreps"],
        cfg["in_site"], cfg["out_site"], alpha=mc["dkw_alpha"],
        complex_offdiag=True, return_fids=False, device=p["device"])
    return {k: v.cpu().numpy() for k, v in out.items()}


def warm(job: Job, cfg: Dict, mix: Dict) -> None:
    unit(job, cfg, mix, WARM_UNIT)


def work(cfg: Dict, mix: Dict, out) -> Dict[str, float]:
    mc = cfg["mc"]
    return {"hams": float(len(mc["noise_levels"]) * mc["controllers"]
                          * mc["bootreps"])}


def valid(cfg: Dict, out) -> bool:
    shape = (len(cfg["mc"]["noise_levels"]), cfg["mc"]["controllers"])
    return (sorted(out) == sorted(ref.metric_names()) and all(
        v.shape == shape and np.isfinite(v).all() for v in out.values()))


def sample(cfg: Dict, mix: Dict, seed: int, units: int) -> np.ndarray:
    """(unit, level, controller) triples drawn from the seed; the last
    unit is always among them."""
    rng = np.random.default_rng([int(seed), 1])
    count = mix["sample_cells"]
    cells = np.column_stack([
        rng.integers(0, units, count),
        rng.integers(0, len(cfg["mc"]["noise_levels"]), count),
        rng.integers(0, cfg["mc"]["controllers"], count)])
    cells[0, 0] = units - 1
    return cells


def readings(cfg: Dict, mix: Dict, inputs: Dict, outs: List[Dict],
             control: bool = False) -> Dict[str, float]:
    """The widest gap of each continuous metric family over the sampled
    cells, of the program's values (``control``: the reference's in the
    precision below the configuration's, ``CONTROLS``) from the float64
    reference's, and ``q_share``: the share of the sampled
    quantile-yield values that differ by more than half a sample (a yield
    moves in steps of 1 / bootreps, so one fidelity that crosses a
    threshold by a rounding moves it a whole step)."""
    mc = cfg["mc"]
    cells = sample(cfg, mix, inputs["seed"], len(outs))
    gaps = {name: 0.0 for name in FAMILIES}
    moved = total = 0
    for u in np.unique(cells[:, 0]):
        lc = cells[cells[:, 0] == u, 1:]
        key = threefry.fold_in(threefry.key(inputs["seed"]), int(u))
        args = (key, cfg["n"], cfg["in_site"], cfg["out_site"],
                inputs["controllers"], inputs["noises"], mc["controllers"],
                mc["bootreps"], lc)
        want = ref.metrics(ref.fidelities(*args, dtype=cfg["dtype"]),
                           mc["dkw_alpha"])
        if control:
            got = ref.metrics(ref.fidelities(
                *args, precision=CONTROLS[cfg["dtype"]], dtype=cfg["dtype"]),
                mc["dkw_alpha"])
        else:
            got = {k: v[lc[:, 0], lc[:, 1]] for k, v in outs[u].items()}
        for k in want:
            diff = np.abs(got[k] - want[k])
            if k.startswith(Q_PREFIX):
                moved += int(np.sum(diff > 0.5 / mc["bootreps"]))
                total += diff.size
            for name, prefix in FAMILIES.items():
                if k.startswith(prefix):
                    gaps[name] = max(gaps[name], float(np.max(diff)))
    gaps["q_share"] = moved / total
    return gaps
