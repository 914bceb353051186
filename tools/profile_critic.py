"""Where the bf16 critic kernel's clocks go, phase by phase, on one CUDA card.

    python3 tools/profile_critic.py [--agents 1024] [--steps 500] [--iters 200]

Run from the repository root.  csrc/critic_train_bf16.cu marks the start of
each phase with a comment line ``// @phase <name>``.  This script writes a
copy of the source in which every such line reads clock64() on lane 0 of
each warp and adds the clocks since the previous reading to the phase that
was running (in shared memory; block 0 writes its sums out at the end),
builds the copy with nvcc into the package's build directory, runs it once
warm at (--agents, --steps, h = 100, --iters), and
prints the launch's CUDA-event time, the registers of the instrumented
build, and per phase the share of each warp's clocks and warp 0's clocks
per iteration.  The readings cost a few percent (the time printed here
against tools/check_critic.py --time) and may move the compiler's
schedule: read the shares, not the absolute clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAX_PHASES = 16
INFRA = """
  __shared__ long long sprof[kWarps][%d];
  if (tid < kWarps * %d) (&sprof[0][0])[tid] = 0;
  long long plast = clock64();
  int pcur = 0;
#define PROF(k) do { if (lane == 0) { long long c_ = clock64(); \\
    sprof[warp][pcur] += c_ - plast; plast = c_; pcur = k; } } while (0)
""" % (MAX_PHASES, MAX_PHASES)


def instrument(src: str):
    """(instrumented source, phase names).  Phase 0 is what runs before the
    first marker (set-up) and after the last one of an iteration."""
    names = ["set-up"]

    def marker(match):
        names.append(match.group(2).strip())
        return f"{match.group(1)}PROF({len(names) - 1});"

    src = re.sub(r"^(\s*)// @phase (.*)$", marker, src, flags=re.M)
    if len(names) < 2 or len(names) > MAX_PHASES:
        raise RuntimeError(f"{len(names) - 1} phase markers found")

    def once(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"expected once in the source: {old!r}")
        src = src.replace(old, new)

    once("int* __restrict__ count_out, Hyper hp) {",
         "int* __restrict__ count_out, Hyper hp, long long* prof) {")
    once("  const int64_t rbase = static_cast<int64_t>(agent) * T;\n",
         "  const int64_t rbase = static_cast<int64_t>(agent) * T;\n" + INFRA)
    once("  for (int i = tid; i < P; i += kThreads) theta_out[pbase + i] = "
         "theta[i];",
         "  PROF(0);\n  __syncthreads();\n"
         f"  if (agent == 0 && tid < kWarps * {MAX_PHASES}) "
         "prof[tid] = (&sprof[0][0])[tid];\n"
         "  for (int i = tid; i < P; i += kThreads) theta_out[pbase + i] = "
         "theta[i];")
    once("      hp);\n  return static_cast<int>(cudaGetLastError());",
         "      hp, prof);\n  return static_cast<int>(cudaGetLastError());")
    once("int A, int device, void* stream) {",
         "int A, int device, void* stream, long long* prof) {")
    once('extern "C" int critic_train_bf16(',
         'extern "C" int critic_train_bf16_prof(')
    return src, names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from code_robchar_tpu_torch.ops import critic
    from code_robchar_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with open(os.path.join(build.CSRC_DIR, "critic_train_bf16.cu")) as f:
        src, names = instrument(f.read())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "critic_train_bf16_prof.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          so, cu], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(out.stdout + out.stderr)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")
    fn = ctypes.CDLL(so).critic_train_bf16_prof
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 10 + [c_int] * 4 + [c_float] * 9 + [c_int] * 2 \
        + [ptr] * 2
    fn.restype = c_int

    a_cnt, t_len, d, h = args.agents, args.steps, 8, 100
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device="cuda")
    theta = torch.as_tensor(
        rng.normal(0, 0.2, (a_cnt, critic.n_params(d + 1, h))), **f32)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    count = torch.zeros(a_cnt, dtype=torch.int32, device="cuda")
    obs = torch.as_tensor(rng.normal(size=(a_cnt, t_len, d)), **f32)
    rets = torch.as_tensor(rng.normal(size=(a_cnt, t_len)), **f32)
    outs = (torch.empty_like(theta), torch.empty_like(mu),
            torch.empty_like(nu), torch.empty_like(count))
    prof = torch.zeros(8 * MAX_PHASES, dtype=torch.int64, device="cuda")
    lb1, lb2 = critic._log_betas(0.9, 0.999)

    def run():
        err = fn(*(x.data_ptr() for x in (theta, mu, nu, count, obs, rets,
                                          *outs)),
                 d + 1, h, t_len, args.iters, 1e-3, 0.9, 0.1, 0.999, 0.001,
                 lb1, lb2, 1e-8, 2.0 / t_len, a_cnt, 0,
                 torch.cuda.current_stream().cuda_stream, prof.data_ptr())
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    clocks = prof.cpu().numpy().reshape(8, MAX_PHASES)[:, :len(names)]
    total = clocks.sum(1)
    print(f"instrumented launch A={a_cnt} T={t_len} h={h} iters="
          f"{args.iters}: {start.elapsed_time(end):.3f} ms; block 0: "
          f"{total[0] / args.iters:.0f} clocks per iteration")
    print(f"{'phase':38s} share of each warp's clocks (%), warps 0-7"
          f"{'':6s} warp 0 clocks/iter")
    for k, name in enumerate(names):
        shares = " ".join(f"{100 * clocks[w, k] / total[w]:5.1f}"
                          for w in range(8))
        print(f"{name:38s} {shares} {clocks[0, k] / args.iters:12.0f}")


if __name__ == "__main__":
    main()
