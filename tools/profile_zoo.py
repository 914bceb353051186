"""Profile the port's zoo path on one CUDA card: where a restart batch's
wall goes between the host and the device.

    python3 tools/profile_zoo.py [--pool 8192] [--table-dir DIR]
                                 [--routes-ab PAIRS]

Run from the repository root.  For each zoo family (L-BFGS, NM, Adam, SNOB)
in chip_smoke.py's zoo configuration (N=7, 0 -> 6, landscape exploration,
float32; L-BFGS and NM with 1024 lanes; Adam's pool is its 64 streams, a
call one 1000-step segment): one warm-up ``_run_batch``, one unprofiled
call for the wall, and one call under ``torch.profiler`` (CPU and CUDA
activities).  For each it prints the rounds, trials, steps and host syncs
(``opt.stats``), the kernel launches the host made (``cudaLaunchKernel``
events) in all and per trial, round or step, the device's busy time (the
union of the device events' intervals), the idle share of the
profiled and of the unprofiled wall, each zoo kernel's launches and mean
time, and the host ops called most often.  ``--table-dir`` also writes
each profile's ``key_averages()`` table there.  Prints nothing as a
device number when the profiler saw no device event.

``--routes-ab PAIRS`` replaces the profiles by an A/B of the zoo kernels'
two routes inside one process: after a warm-up, PAIRS pairs of unprofiled
``_run_batch`` calls on one pool of starts and one seed, alternately as
ops/cuda_jacobi.py routes the shapes (the lane-group kernels) and with the
route thresholds set to 0 for the call (one thread per matrix), in turns
group, one, one, group.  It prints every wall and every wall per trial
(L-BFGS) or per round (NM) with each side's medians: the two routes'
roundings part the trajectories, so the sides' counts differ a little.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def _busy_us(events) -> float:
    """Length of the union of the device events' time intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile(cls, warm: int, timed: int, profiled: int, pool: int,
            table_dir: str | None) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from code_robchar_tpu_torch.ops import prng

    opt = cls(7, 0, 6, testing=True, fid_threshold=2.0, repeats=10**9,
              run_until_told_to_stop=True, run_until_completion_its=10**12,
              landscape_exploration=True, save_topc=64, device="cuda",
              dtype=torch.float32)

    if opt.persistent_streams:
        pool = opt.default_batch

    def run(seed):
        x0s = torch.as_tensor(opt.init_points(pool), dtype=torch.float32,
                              device="cuda")
        res = opt._run_batch(x0s, prng.split(prng.key(seed), pool))
        float(res.fid.sum())

    run(warm)
    start = time.perf_counter()
    run(timed)
    wall = time.perf_counter() - start
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run(profiled)
        prof_wall = time.perf_counter() - start
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(e.name in LAUNCH_NAMES for e in events)
    unit = next(u for u in ("trials", "steps", "rounds") if u in opt.stats)
    print(f"{cls.name}: N=7 pool {pool} lanes "
          f"{getattr(opt, 'lane_width', pool)}; stats {opt.stats}; wall "
          f"{wall:.4f} s unprofiled, {prof_wall:.4f} s profiled; host kernel "
          f"launches {launches}, {launches / opt.stats[unit]:.1f} per "
          f"{unit[:-1]}; unprofiled {wall / opt.stats[unit] * 1e3:.4f} ms "
          f"per {unit[:-1]}")
    if not device:
        print(f"{cls.name}: the profiler saw no device event: device busy "
              f"time and idle share not measured")
    else:
        busy = _busy_us(device) / 1e6
        print(f"{cls.name}: device busy {busy * 1e3:.1f} ms; idle "
              f"{1 - busy / prof_wall:.4f} of the profiled wall, "
              f"{1 - busy / wall:.4f} of the unprofiled wall")
        for name in ("sym_jacobi_grad_kernel", "sym_jacobi_grad_group_kernel",
                     "sym_jacobi_amp_kernel", "sym_jacobi_amp_group_kernel"):
            ks = [e for e in device if name in e.name]
            if ks:
                total = sum(e.time_range.elapsed_us() for e in ks)
                print(f"{cls.name}: {name} {len(ks)} launches, "
                      f"{total / 1e3:.1f} ms, {total / len(ks):.2f} us each")
    avgs = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CPU]
    top = sorted(avgs, key=lambda a: a.count, reverse=True)[:12]
    print(f"{cls.name}: host ops by calls: " + "; ".join(
        f"{a.key} {a.count} ({a.self_cpu_time_total / 1e3:.0f} ms self)"
        for a in top))
    if table_dir:
        os.makedirs(table_dir, exist_ok=True)
        path = os.path.join(table_dir, f"profile_zoo_{cls.name}.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="count",
                                              row_limit=200))
        print(f"{cls.name}: table -> {path}")


def routes_ab(cls, warm: int, seed: int, pool: int, pairs: int) -> None:
    import contextlib
    import statistics
    from unittest import mock

    from code_robchar_tpu_torch.ops import cuda_jacobi, prng

    opt = cls(7, 0, 6, testing=True, fid_threshold=2.0, repeats=10**9,
              run_until_told_to_stop=True, run_until_completion_its=10**12,
              landscape_exploration=True, save_topc=64, device="cuda",
              dtype=torch.float32)

    x0s = torch.as_tensor(opt.init_points(pool), dtype=torch.float32,
                          device="cuda")

    def run(seed):
        start = time.perf_counter()
        res = opt._run_batch(x0s, prng.split(prng.key(seed), pool))
        float(res.fid.sum())
        return time.perf_counter() - start

    sides = {
        "group": contextlib.nullcontext,
        "one": lambda: mock.patch.multiple(cuda_jacobi, AMP_GROUP_MAX_B=0,
                                           GRAD_GROUP_MAX_B=0),
    }
    run(warm)
    walls = {side: [] for side in sides}
    each = {side: [] for side in sides}
    for i in range(pairs):
        for side in (list(sides), list(sides)[::-1])[i % 2]:
            with sides[side]():
                walls[side].append(run(seed))
            steps = opt.stats.get("trials", opt.stats["rounds"])
            each[side].append(walls[side][-1] / steps * 1e3)
    for side, ws in walls.items():
        print(f"{cls.name} routes A/B, {side}: walls "
              f"{[round(w, 4) for w in ws]} s, median "
              f"{statistics.median(ws):.4f} s; ms per trial (L-BFGS) or "
              f"round (NM) {[round(x, 4) for x in each[side]]}, median "
              f"{statistics.median(each[side]):.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pool", type=int, default=8192)
    ap.add_argument("--table-dir", default=None)
    ap.add_argument("--routes-ab", type=int, default=0, metavar="PAIRS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_zoo.py needs a CUDA device")
    from code_robchar_tpu_torch.models import SNOB, Adam, LBFGS, NMPlus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.routes_ab:
        routes_ab(LBFGS, 5, 7, args.pool, args.routes_ab)
        routes_ab(NMPlus, 15, 16, args.pool, args.routes_ab)
        return
    # the seeds of chip_smoke.py's zoo phases: warm-up, timed, profiled
    for cls, seeds in ((LBFGS, (5, 7, 8)), (NMPlus, (15, 16, 17)),
                       (Adam, (35, 36, 37)), (SNOB, (25, 26, 27))):
        profile(cls, *seeds, args.pool, args.table_dir)


if __name__ == "__main__":
    main()
