"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports only the port (code_robchar_tpu_torch),
never jax, and fails — non-zero exit, no result line — when any phase
fails, when no CUDA device is present, or when the package is missing.

Phases:

0. device: require CUDA; print the nvidia-smi name and power limit.
1. build: compile csrc/*.cu with nvcc (utils/build.py) and print the build
   seconds and the compiler's register / spill report per kernel instance.
2. kernel vs plain: the CUDA Jacobi fidelity kernel against the plain torch
   version on the card (max abs <= 3e-5) and against a float64
   torch.linalg.eigh oracle (<= 3e-5), on random Hermitian batches from
   numpy seed 0 (n in {4, 7, 10}, a ragged B = 5000, the main path's chunk
   width B = 131000 at n = 7, in/out in {(0, n-1), (1, 2)}); then both
   timed at n = 7, B = 131072 with CUDA events.
3. main path at full size: engine.mc_metric_sweep on the bench.py workload
   (N=7 chain, 10,000 controllers x 11 noise levels x 100 bootstrap reps,
   seed 0, in 0 -> out 6, complex couplings, alpha 0.05): one warm-up with
   key(0), three timed runs with key(1..3).  Prints the median wall
   seconds, Hamiltonians/s, the kernel launches of those runs (must be
   > 0) and rim_checksum = sum of the RIM tensor of the key(1) run, which
   must lie within 1.0 of the JAX package's value for the same key and
   inputs (109979.109).  All 15 metric tensors must be finite, of shape
   (11, 10000), and agree on a 16-controller slice with the float64 plain
   path on the CPU (RIM, std, worst case within 1e-3: float32 rounding of
   phases lam*t up to a few hundred radians).
4. the kernels JSON line, then {"ok": true, "device": {...}} as the last
   line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

JAX_RIM_CHECKSUM = 109979.109   # JAX package, same key and inputs
TOL_KERNEL = 3e-5
TOL_SLICE = 1e-3


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA device and has no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from code_robchar_tpu_torch.utils import build

    res = build.build()
    print(f"build: {res.seconds:.2f} s (cached={res.cached}) -> {res.path}")
    for line in res.log.splitlines():
        if any(w in line for w in ("Function", "REG", "registers", "spill",
                                   "stack", "STACK")):
            print(f"  nvcc: {line.strip()}")
    return res


def _hermitian_batch(rng, n, b):
    a = rng.normal(size=(b, n, n))
    sym = (a + a.transpose(0, 2, 1)) / 2
    s = rng.normal(size=(b, n, n))
    skew = (s - s.transpose(0, 2, 1)) / 2
    t = rng.uniform(1, 5, b)
    return (np.moveaxis(sym, 0, -1).astype(np.float32).copy(),
            np.moveaxis(skew, 0, -1).astype(np.float32).copy(),
            t.astype(np.float32))


def _oracle(ar, ai, t, i, o):
    h = torch.as_tensor(np.moveaxis(ar, -1, 0), dtype=torch.float64) \
        + 1j * torch.as_tensor(np.moveaxis(ai, -1, 0), dtype=torch.float64)
    lam, v = torch.linalg.eigh(h)
    tt = torch.as_tensor(t, dtype=torch.float64)[:, None]
    ph = (v[:, o, :] * v[:, i, :].conj() * torch.exp(-1j * lam * tt)).sum(-1)
    return (ph.abs() ** 2).numpy()


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel():
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = 0.0
    cases = [(n, b) for n in (4, 7, 10) for b in (5000,)] + [(7, 131000)]
    for n, b in cases:
        ar, ai, t = _hermitian_batch(rng, n, b)
        gar, gai, gt = (torch.as_tensor(x, device=dev) for x in (ar, ai, t))
        for i, o in ((0, n - 1), (1, 2)):
            got = cuda_jacobi.fidelity_herm(gar, gai, gt, i, o)
            plain = realform.fidelity_herm_lanes(gar, gai, gt, i, o)
            torch.cuda.synchronize()
            got = got.cpu().numpy()
            err_plain = float(np.abs(got - plain.cpu().numpy()).max())
            err_oracle = float(np.abs(got - _oracle(ar, ai, t, i, o)).max())
            ok = (np.isfinite(got).all() and err_plain <= TOL_KERNEL
                  and err_oracle <= TOL_KERNEL)
            print(f"kernel n={n} B={b} in={i} out={o}: max|kernel-plain| "
                  f"{err_plain:.3e}, max|kernel-f64 eigh| {err_oracle:.3e} "
                  f"(tol {TOL_KERNEL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"kernel disagrees at n={n} B={b} "
                                   f"in={i} out={o}")
            worst = max(worst, err_plain)

    n, b = 7, 131072
    ar, ai, t = _hermitian_batch(rng, n, b)
    gar, gai, gt = (torch.as_tensor(x, device=dev) for x in (ar, ai, t))
    timings = {}
    for label, fn, reps in (
            ("plain", lambda: realform.fidelity_herm_lanes(gar, gai, gt, 0, 6),
             3),
            ("kernel", lambda: cuda_jacobi.fidelity_herm(gar, gai, gt, 0, 6),
             50),
            ("kernel", lambda: cuda_jacobi.fidelity_herm(gar, gai, gt, 0, 6),
             50),
            ("plain", lambda: realform.fidelity_herm_lanes(gar, gai, gt, 0, 6),
             3)):
        timings.setdefault(label, []).append(_time_ms(fn, reps))
    ms = min(timings["kernel"])
    plain_ms = min(timings["plain"])
    print(f"timing n=7 B=131072: kernel {timings['kernel']} ms, plain "
          f"{timings['plain']} ms (min: {ms:.4f} vs {plain_ms:.3f} ms, "
          f"{b / ms / 1e3:.1f} M Hams/s in the kernel)")
    return worst, ms, plain_ms


def phase_main_path():
    from code_robchar_tpu_torch.mc import engine
    from code_robchar_tpu_torch.ops import chain, cuda_jacobi, prng

    n, n_ctrl, n_noise, bootreps = 7, 10_000, 11, 100
    total = n_ctrl * n_noise * bootreps
    rng = np.random.default_rng(0)
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float32)
    ctrl = np.column_stack([rng.uniform(-10, 10, (n_ctrl, n)),
                            rng.uniform(0, 30, n_ctrl)]).astype(np.float32)
    noises = np.linspace(0, 0.1, n_noise).astype(np.float32)
    kwargs = dict(complex_offdiag=True, alpha=0.05, device="cuda")

    def run(k):
        return engine.mc_metric_sweep(h0, ctrl, noises, prng.key(k),
                                      bootreps, 0, 6, **kwargs)

    cuda_jacobi.LAUNCHES = 0
    warm = run(0)
    float(warm[engine.RIM_NAME].sum())
    times, checksum, first = [], None, None
    for i in range(3):
        start = time.perf_counter()
        metrics = run(1 + i)
        cs = float(metrics[engine.RIM_NAME].sum(dtype=torch.float64))
        times.append(time.perf_counter() - start)
        if checksum is None:
            checksum, first = cs, metrics
    launches = cuda_jacobi.LAUNCHES
    wall = statistics.median(times)
    print(f"main path: N={n} {n_ctrl} controllers x {n_noise} noise levels x "
          f"{bootreps} bootreps = {total} Hamiltonians; wall {times} s, "
          f"median {wall:.4f} s, {total / wall:.1f} Hams/s; kernel launches "
          f"{launches} over 4 runs")
    if launches <= 0:
        raise RuntimeError("the main path launched no CUDA kernel")

    for name, v in first.items():
        if v.shape != (n_noise, n_ctrl) or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"metric {name!r}: shape {tuple(v.shape)}, "
                               f"finite {bool(torch.isfinite(v).all())}")
    delta = checksum - JAX_RIM_CHECKSUM
    print(f"rim_checksum {checksum:.3f} vs JAX {JAX_RIM_CHECKSUM} "
          f"(delta {delta:+.4f}, tol 1.0)")
    if abs(delta) > 1.0:
        raise RuntimeError(f"rim_checksum {checksum} misses the JAX value "
                           f"{JAX_RIM_CHECKSUM} by {delta}")

    # the same slice through the float64 plain path on the CPU
    sl = 16
    ref = engine.mc_metric_sweep(h0.double(), ctrl[:sl].astype(np.float64),
                                 noises.astype(np.float64), prng.key(1),
                                 bootreps, 0, 6, complex_offdiag=True,
                                 alpha=0.05, device="cpu")
    part = engine.mc_metric_sweep(h0, ctrl[:sl], noises, prng.key(1),
                                  bootreps, 0, 6, **kwargs)
    for name in (engine.RIM_NAME, "std", "worst case fid"):
        err = float((part[name].cpu().double() - ref[name]).abs().max())
        print(f"slice {name!r}: max|cuda f32 - cpu f64| {err:.3e} "
              f"(tol {TOL_SLICE:g})")
        if err > TOL_SLICE:
            raise RuntimeError(f"main path disagrees with the f64 plain "
                               f"path on {name!r}: {err}")
    return launches, wall, total / wall, checksum


def main():
    smi = phase_device()
    res = phase_build()
    err, ms, plain_ms = phase_kernel()
    launches, wall, rate, checksum = phase_main_path()
    kernels = [{
        "name": "herm_jacobi_fidelity",
        "route": "cuda",
        "source": "code_robchar_tpu_torch/csrc/herm_jacobi_fidelity.cu",
        "replaces": "code_robchar_tpu/ops/pallas_jacobi.py:209",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    print(f"summary: build {res.seconds:.2f} s; main path {wall:.4f} s, "
          f"{rate:.1f} Hams/s, rim_checksum {checksum:.3f}; card {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
