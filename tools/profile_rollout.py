"""Where the clocks of the PPO rollout kernel go, phase by phase, and how
many of its blocks the card holds at once, on one CUDA card.

    python3 tools/profile_rollout.py [--agents 1024] [--steps 500]
        [--parent DIR]

Run from the repository root.  csrc/actor_env_rollout.cu marks the end of
each phase of its work with a comment line ``// @phase <name>``: per step
the actor's three layers, the wrap and bookkeeping, the block barriers;
after the steps the T Jacobi fidelities.  This script writes a copy in
which every such line reads clock64() and adds the clocks since the
previous reading to that phase (thread 0 of block 0 writes its sums out
after the last phase; every block writes its SM and the card's ns timer
at its start and end), builds it with nvcc into the package's build
directory and runs it once warm at the PPO path's shapes (N=7, h=100,
A=1024, T=500, 4 sweeps, ham_noisy; weights and noise from numpy seed 0)
through the C entry of the path's kernel (``actor_env_rollout_reg``; a
checkout from before that entry has the generic one alone).

It prints the card's name and power limit, the registers and shared
memory of the launched kernel, the clocks of thread 0 by phase (the sum,
its share, the clocks per step), the largest number of blocks resident at
once on the card and on one SM (from the timers), and the launch's
milliseconds card-paced (launches enqueued behind a ~30 ms spin).
``--parent DIR`` builds the kernel also from DIR's code_robchar_tpu_torch
(a checkout of another commit, e.g. from ``git archive``) and times both,
without the readings, in turns parent, tree, tree, parent.

The readings cost clocks and registers: read the shares, not the absolute
clocks.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_jacobi  # noqa: E402  (tools/profile_jacobi.py)

PHASES = ("load", "layer 1", "layer 2", "layer 3", "wrap", "barriers",
          "jacobi")
MAX_BLOCKS = 8192

PROLOGUE = """
#define JPROF_PHASES %d
#define JPROF_MAX_BLOCKS %d
#define JPROF(k) do { long long c_ = clock64(); pacc[k] += c_ - plast; \\
    plast = c_; } while (0)
__device__ long long g_prof[JPROF_PHASES];
__device__ unsigned g_smid[JPROF_MAX_BLOCKS];
__device__ unsigned long long g_span[2 * JPROF_MAX_BLOCKS];
__device__ __forceinline__ unsigned long long jprof_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
""" % (len(PHASES), MAX_BLOCKS)

START = """
  long long pacc[JPROF_PHASES];
#pragma unroll
  for (int i_ = 0; i_ < JPROF_PHASES; ++i_) pacc[i_] = 0;
  if (threadIdx.x == 0 && blockIdx.x < JPROF_MAX_BLOCKS) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_smid[blockIdx.x] = sm;
    g_span[2 * blockIdx.x] = jprof_ns();
  }
  long long plast = clock64();
"""

END = """ if (threadIdx.x == 0) {
    if (blockIdx.x < JPROF_MAX_BLOCKS) g_span[2 * blockIdx.x + 1] = jprof_ns();
    if (blockIdx.x == 0) {
#pragma unroll
      for (int i_ = 0; i_ < JPROF_PHASES; ++i_) g_prof[i_] = pacc[i_];
    }
  }"""

READER = """
extern "C" int jprof_read(long long* prof, unsigned* smid,
                          unsigned long long* span) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(prof, g_prof, sizeof(g_prof));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(smid, g_smid, sizeof(g_smid));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(span, g_span, sizeof(g_span));
  return static_cast<int>(e);
}
"""


def instrument(src: str) -> str:
    """actor_env_rollout.cu with the readings compiled in: every kernel
    starts its sums where it names its thread (``const int tid =
    threadIdx.x;``), every marker reads
    the clock, the ``jacobi`` marker also writes the readings out, and a C
    entry reads them back."""
    anchor = "namespace {\n"
    if src.count(anchor) != 1:
        raise RuntimeError("actor_env_rollout.cu: anchor not found once")
    src = src.replace(anchor, PROLOGUE + anchor)
    src, kernels = re.subn(r"^(\s*const int tid = threadIdx\.x;)$",
                           lambda m: m.group(1) + START, src, flags=re.M)
    if kernels < 1:
        raise RuntimeError("actor_env_rollout.cu: no kernel found")

    def marker(match):
        k = PHASES.index(match.group(2).strip())
        tail = END if PHASES[k] == "jacobi" else ""
        return f"{match.group(1)}JPROF({k});{tail}"

    src = re.sub(r"^(\s*)// @phase (.*)$", marker, src, flags=re.M)
    return src + READER


def start_build(build, csrc, tag, instrumented=True):
    """Start nvcc on a copy (instrumented or not) of ``csrc``'s rollout
    kernel and its header under build/profile_rollout/<tag>/; (library,
    process)."""
    out_dir = os.path.join(build.BUILD_DIR, "profile_rollout", tag)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "jacobi_common.cuh")) as f:
        header = f.read()
    with open(os.path.join(out_dir, "jacobi_common.cuh"), "w") as f:
        f.write(header)
    with open(os.path.join(csrc, "actor_env_rollout.cu")) as f:
        src = f.read()
    cu = os.path.join(out_dir, "actor_env_rollout_prof.cu")
    with open(cu, "w") as f:
        f.write(instrument(src) if instrumented else src)
    return cu[:-3] + ".so", subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", cu[:-3] + ".so",
         cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def inputs(n, hid, a_cnt, t_len, seed=0):
    """Actor weights, a carry and the noise streams, float32 on the card,
    in the kernel's layout (ops/rollout.py)."""
    rng = np.random.default_rng(seed)
    d = n + 1
    f32 = dict(dtype=torch.float32, device="cuda")

    def dense(i, o):
        w = rng.normal(0, 1 / np.sqrt(i), (a_cnt, i, o))
        return np.concatenate([w, rng.normal(0, 0.1, (a_cnt, 1, o))], 1)

    h0 = np.zeros((n, n))
    h0[np.arange(n - 1), np.arange(1, n)] = 1.0
    return [torch.as_tensor(x, **f32).contiguous() for x in (
        dense(d, hid), dense(hid, hid), dense(hid, d),
        rng.normal(-0.5, 0.2, (a_cnt, d)), h0 + h0.T,
        rng.uniform(-4, 4, (n, a_cnt)), rng.uniform(2, 20, a_cnt))] + [
        torch.as_tensor(rng.integers(0, 40, a_cnt), dtype=torch.int32,
                        device="cuda")] + [
        torch.as_tensor(x, **f32).contiguous() for x in (
            rng.normal(size=(t_len, d, a_cnt)),
            rng.normal(0, 0.05, (t_len, n, a_cnt)),
            rng.normal(0, 0.05, (t_len, n - 1, a_cnt)))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from code_robchar_tpu_torch.ops import cuda_jacobi, rollout
    from code_robchar_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) / 1e3
    n, hid, a_cnt, t_len, sweeps = (7, rollout.REG_HIDDEN, args.agents,
                                    args.steps, 4)
    d = n + 1
    trees = {"tree": os.path.join(ROOT, "code_robchar_tpu_torch", "csrc")}
    if args.parent:
        trees["parent"] = os.path.join(args.parent, "code_robchar_tpu_torch",
                                       "csrc")
    # the readings of the tree's kernel; both kernels are timed
    procs = {"tree": start_build(build, trees["tree"], "tree")}
    plain = {tag: start_build(build, csrc, tag + "_plain", False)
             for tag, csrc in trees.items()}
    ins = inputs(n, hid, a_cnt, t_len)
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = [torch.empty((t_len, d, a_cnt), **f32),
            torch.empty((t_len, a_cnt), **f32),
            torch.empty((t_len, d, a_cnt), **f32),
            torch.empty((t_len, a_cnt), dtype=torch.bool, device="cuda"),
            torch.empty((t_len, a_cnt), dtype=torch.bool, device="cuda"),
            torch.empty((n, a_cnt), **f32), torch.empty(a_cnt, **f32),
            torch.empty(a_cnt, dtype=torch.int32, device="cuda")]
    runs = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(so)
        fn = path_entry(lib)
        lib.jprof_read.argtypes = [ctypes.c_void_p] * 3

        def run(fn=fn):
            err = fn(*(x.data_ptr() for x in ins + outs), n, hid, 0, n - 1,
                     sweeps, cuda_jacobi.EPS, 10.0, 30.0, 1000, 1, t_len,
                     a_cnt, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{tag}: CUDA error {err}")

        runs[tag] = run
        print(f"\n{tag} with the readings: kernels of N={n} (registers, "
              f"stack, spills, shared memory):")
        print_resources(log, [n])
        for _ in range(2):
            run()
        prof = np.zeros(len(PHASES), dtype=np.int64)
        smid = np.zeros(MAX_BLOCKS, dtype=np.uint32)
        span = np.zeros(2 * MAX_BLOCKS, dtype=np.uint64)
        if lib.jprof_read(prof.ctypes.data, smid.ctypes.data,
                          span.ctypes.data):
            raise SystemExit("reading back failed")
        blocks = min(a_cnt, MAX_BLOCKS)
        t0 = span[0:2 * blocks:2].astype(np.int64)
        t1 = span[1:2 * blocks:2].astype(np.int64)
        peak = max_live(t0, t1)
        per_sm = [max_live(t0[smid[:blocks] == s], t1[smid[:blocks] == s])
                  for s in np.unique(smid[:blocks])]
        tot = int(prof.sum())
        print(f"  blocks resident at once: {peak} on the card, at most "
              f"{max(per_sm)} on one SM; block 0 lasted "
              f"{(t1[0] - t0[0]) / 1e3:.1f} us, the launch "
              f"{(t1.max() - t0.min()) / 1e3:.1f} us (the card's timer)")
        print(f"  thread 0 of block 0: {tot} clocks "
              f"({tot / ghz * 1e-3:.1f} us at {ghz:.3f} GHz)")
        for k, phase in enumerate(PHASES):
            if prof[k]:
                print(f"    {phase:10s} {int(prof[k]):10d} clocks "
                      f"{100 * prof[k] / tot:5.1f}%  "
                      f"{prof[k] / t_len:9.1f} per step")
    timed = {}
    for tag, (so, proc) in plain.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        if tag == "tree":
            print("\ntree: kernels of N=2..10 with ham_noisy (registers, "
                  "stack, spills, shared memory):")
            print_resources(log, range(2, 11))
        timed[tag] = lambda fn=path_entry(ctypes.CDLL(so)): runs["tree"](fn)
    ms = {tag: [] for tag in timed}
    order = [t for t in ("parent", "tree") if t in timed]
    order = order + order[::-1]
    for tag in order:
        ms[tag].append(profile_jacobi.time_ms(timed[tag], reps=5,
                                              behind_spin=True))
    print(f"\ncard-paced ms per launch (builds without the readings; A={a_cnt} "
          f"T={t_len} h={hid}): " + ", ".join(f"{k} {v}"
                                             for k, v in ms.items()))


def print_resources(log, sizes):
    """Print nvcc's report of both kernels' ham_noisy instances at the
    matrix sizes ``sizes`` from the build log ``log``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"(actor_env_rollout(?:_reg)?_kernel)ILi(\d+)ELb1E",
                      line)
        if "Compiling entry function" in line and m and \
                int(m.group(2)) in sizes:
            print(f"  {m.group(1)} n={m.group(2)}: " + " ".join(
                x.strip().replace("ptxas info    : ", "")
                for x in lines[i + 2:i + 4]))


def path_entry(lib):
    """The C entry of the kernel that the PPO path's width takes in the
    library ``lib``: ``actor_env_rollout_reg`` where the build has it, else
    (a checkout from before it) ``actor_env_rollout``."""
    name = ("actor_env_rollout_reg" if hasattr(lib, "actor_env_rollout_reg")
            else "actor_env_rollout")
    fn = getattr(lib, name)
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [_p] * 19 + [_i] * 5 + [_f] * 3 + [_i] * 5 + [_p]
    return fn


def max_live(t0, t1):
    """The most intervals [t0, t1) that overlap at one time."""
    ev = sorted([(x, 1) for x in t0] + [(x, -1) for x in t1],
                key=lambda e: (e[0], e[1]))
    live = peak = 0
    for _, step in ev:
        live += step
        peak = max(peak, live)
    return peak


if __name__ == "__main__":
    main()
