"""The readings that a cell's limits are set from: the program's sound runs
and the control, in one process.

    python3 -m robchar_bench.control --workload <cell> --seeds S [S ...] \
        [--units K]

For each seed: the cell's set-up, ``K`` units of its timed path at the
cell's own size (the mix's ``traced_units`` by default), then the
reference's readings of those outputs (``program``) and of the control
(``control``: the reference computed in the precision just below the one
its configuration states, put in the program's place).  Which control goes
with which ``dtype`` (TF32 off in both):

- float32: the reference with every operand rounded to TF32 (the PPO
  critic's bf16 operands to float8 e4m3);
- float64 (the ``mc`` driver, ``drivers/mc.CONTROLS``): the reference with
  every operand rounded to float32.

One JSON line a seed, then the largest program reading and the smallest
control reading of each number.  Needs the cell's device (the card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from robchar_bench import harness


def readings(spec, seeds, units, device="cuda", log=print):
    """{seed: {"program": {...}, "control": {...}}} over ``seeds``."""
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    out = {}
    for i, seed in enumerate(seeds):
        start = time.perf_counter()
        job = harness.prepare(spec, seed, device, warm=i == 0)
        outs = [driver.unit(job, cfg, mix, u) for u in range(units)]
        inputs = job.inputs
        del job
        row = {"program": driver.readings(cfg, mix, inputs, outs),
               "control": driver.readings(cfg, mix, inputs, outs,
                                          control=True)}
        out[seed] = row
        log(json.dumps({"seed": seed, **row,
                        "seconds": time.perf_counter() - start}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the cell's device: no CUDA device",
              file=sys.stderr)
        return 2
    spec = harness.cell_spec(harness.load_json(harness.bench_path()),
                             args.workload)
    units = args.units or spec["mix"]["traced_units"]
    rows = readings(spec, args.seeds, units)
    names = next(iter(rows.values()))["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows), "units": units,
        "program_max": {k: max(r["program"][k] for r in rows.values())
                        for k in names},
        "control_min": {k: min(r["control"][k] for r in rows.values())
                        for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
