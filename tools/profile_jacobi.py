"""Where the clocks of the zoo's two Jacobi kernels go, phase by phase, and
how much of the card a launch occupies, on one CUDA card.

    python3 tools/profile_jacobi.py [--n 7] [--routes one,group]
        [--amp-b 9216] [--grad-b 1024] [--sweep]

Run from the repository root.  csrc/jacobi_common.cuh, sym_jacobi_amp.cu
and sym_jacobi_grad.cu mark the end of each phase of their work with a
comment line ``// @phase <name>`` (``// @phase(st) <name>`` outside the
state's member functions).  This script writes copies of the three sources
in which every such line reads clock64() and adds the clocks since the
previous reading to that phase (in registers of every thread; thread 0 of
block 0 writes its sums out at the end, and thread 0 of every block writes
the number of the SM it ran on), builds each copy with nvcc into the
package's build directory, and runs every asked route ("one": one thread
per matrix, "group": a group of lanes per matrix) of both kernels once warm
at the batch the zoo gives it.

It prints the card's name and power limit; per kernel and route the
registers of the instrumented build, the clocks of thread 0 by phase (the
sum, its share and the clocks per sweep), the SMs the launch ran on and
the warps per scheduler there; then each route's milliseconds per launch
in two ways — host-paced (100 launches between two CUDA events on an idle
card: where the host enqueues more slowly than the card runs, this is the
host's pace) and card-paced (the same 100 launches enqueued behind a spin
of ~30 ms, so that they run back to back) — beside an empty kernel's
(launch_floor_ms, csrc/launch_floor.cu) both ways.  With ``--sweep`` it
then times both routes of both kernels card-paced at batches from 1024 to
131072: the crossover sets the route thresholds AMP_GROUP_MAX_B and
GRAD_GROUP_MAX_B of ops/cuda_jacobi.py.

The readings cost clocks and registers and may move the compiler's
schedule (arithmetic of the next phase can start before a reading): read
the shares, not the absolute clocks.
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

PHASES = ("load", "angles", "exchange", "A update", "V update",
          "amplitude epilogue", "DK contraction", "store")
MAX_BLOCKS = 8192
SPIN_CYCLES = 50_000_000            # ~30 ms on an H100
SWEEP_BATCHES = (1024, 2048, 4096, 8192, 9216, 12288, 16384, 24576, 32768,
                 49152, 65536, 131072)
SUFFIX = {"one": "", "group": "_group"}
THREADS = {"one": 128, "group": 32}

PROLOGUE = """
#define JPROF_PHASES %d
#define JPROF_MAX_BLOCKS %d
#define JPROF(k) do { long long c_ = clock64(); pacc[k] += c_ - plast; \\
    plast = c_; } while (0)
#define JPROF_ST(k) do { long long c_ = clock64(); \\
    st.pacc[k] += c_ - st.plast; st.plast = c_; } while (0)
__device__ long long g_prof[JPROF_PHASES];
__device__ unsigned g_smid[JPROF_MAX_BLOCKS];
template <class State>
__device__ __forceinline__ void jprof_begin(State& st) {
#pragma unroll
  for (int i = 0; i < JPROF_PHASES; ++i) st.pacc[i] = 0;
  st.plast = clock64();
}
template <class State>
__device__ __forceinline__ void jprof_end(const State& st) {
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
    if (blockIdx.x < JPROF_MAX_BLOCKS) g_smid[blockIdx.x] = sm;
    if (blockIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < JPROF_PHASES; ++i) g_prof[i] = st.pacc[i];
    }
  }
}
""" % (len(PHASES), MAX_BLOCKS)

READER = """
extern "C" int jprof_read(long long* prof, unsigned* smid) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(prof, g_prof, sizeof(g_prof));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(smid, g_smid, sizeof(g_smid));
  return static_cast<int>(e);
}
"""


def _markers(src: str) -> str:
    def marker(match):
        k = PHASES.index(match.group(3).strip())
        macro = "JPROF_ST" if match.group(2) else "JPROF"
        tail = " jprof_end(st);" if PHASES[k] == "store" else ""
        return f"{match.group(1)}{macro}({k});{tail}"

    return re.sub(r"^(\s*)// @phase(\(st\))? (.*)$", marker, src, flags=re.M)


def instrument_header(src: str) -> str:
    """The shared header with the clock readings compiled in: the state
    gains its sums, every marker a reading."""
    member = "  float v[R][N];               // carried eigenvector rows\n"
    anchor = "namespace jacobi {\n"
    if src.count(member) != 1 or src.count(anchor) != 1:
        raise RuntimeError("jacobi_common.cuh: anchors not found once")
    src = src.replace(anchor, PROLOGUE + anchor)
    src = src.replace(member, member + "  long long pacc[JPROF_PHASES];\n"
                      "  long long plast;\n")
    return _markers(src)


def instrument_kernel(src: str) -> str:
    """A kernel source with the readings compiled in and a C entry that
    reads them back."""
    src, n = re.subn(r"^(\s*jacobi::SymState<N, [^>]+> st;)$",
                     r"\1 jprof_begin(st);", src, flags=re.M)
    if n != 2:
        raise RuntimeError(f"expected the state declared twice, found {n}")
    return _markers(src) + READER


def start_builds(build, tag, instrumented):
    """Start one nvcc per kernel source on copies under
    build/profile_jacobi/<tag>/; {"amp": (library path, process), ...}."""
    out_dir = os.path.join(build.BUILD_DIR, "profile_jacobi", tag)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "jacobi_common.cuh")) as f:
        header = f.read()
    with open(os.path.join(out_dir, "jacobi_common.cuh"), "w") as f:
        f.write(instrument_header(header) if instrumented else header)
    procs = {}
    for kind in ("amp", "grad"):
        with open(os.path.join(build.CSRC_DIR, f"sym_jacobi_{kind}.cu")) as f:
            src = f.read()
        cu = os.path.join(out_dir, f"sym_jacobi_{kind}_prof.cu")
        with open(cu, "w") as f:
            f.write(instrument_kernel(src) if instrumented else src)
        procs[kind] = (cu[:-3] + ".so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs):
    """{"amp": (CDLL, nvcc's report), "grad": ...} of ``start_builds``."""
    libs = {}
    for kind, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        libs[kind] = (ctypes.CDLL(so), log)
    return libs


def resources(log: str, kernel: str, n: int) -> str:
    """The registers / stack / spill lines of ``kernel<n>`` in an nvcc
    --resource-usage log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"{kernel}ILi{n}E" in line:
            return " ".join(x.strip().replace("ptxas info    : ", "")
                            for x in lines[i + 2:i + 4])
    return "not found in the compiler's report"


def time_ms(fn, reps=100, behind_spin=False):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if behind_spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def entry(lib, name, n_tensors):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=7)
    ap.add_argument("--routes", default="one,group")
    ap.add_argument("--amp-b", type=int, default=9216)
    ap.add_argument("--grad-b", type=int, default=1024)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    routes = args.routes.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform
    from code_robchar_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    props = torch.cuda.get_device_properties(0)
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) / 1e3
    n = args.n
    sweeps = realform._sweeps_for(torch.float32, n)
    f32 = dict(dtype=torch.float32, device="cuda")

    def inputs(kind, b):
        """The same inputs every time, and fresh outputs."""
        rng = np.random.default_rng(b)
        if kind == "amp":
            a = rng.normal(size=(n, n, b))
            return (torch.as_tensor(a + a.transpose(1, 0, 2), **f32) / 2,
                    torch.as_tensor(rng.uniform(1, 5, b), **f32),
                    torch.empty((2, b), **f32))
        h0 = rng.normal(size=(n, n))
        xs = np.column_stack([rng.uniform(-2, 2, (b, n)),
                              rng.uniform(0.5, 5, b)])
        return (torch.as_tensor((h0 + h0.T) / 2, **f32),
                torch.as_tensor(xs, **f32).contiguous(),
                torch.empty(b, **f32), torch.empty((b, n + 1), **f32))

    def call(fn, tensors, b):
        err = fn(*(x.data_ptr() for x in tensors), n, 0, n - 1, sweeps,
                 cuda_jacobi.EPS, b, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")

    # copies with and without the readings; all four nvcc processes run
    # side by side
    started = (start_builds(build, "readings", True),
               start_builds(build, "plain", False))
    with_readings, without = (finish_builds(procs) for procs in started)

    def reading(kind, b, route):
        """Run one instrumented kernel once warm and print its readings."""
        lib, log = with_readings[kind]
        tensors = inputs(kind, b)
        name = f"sym_jacobi_{kind}{SUFFIX[route]}"
        fn = entry(lib, name, len(tensors))
        lib.jprof_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for _ in range(2):
            call(fn, tensors, b)
            torch.cuda.synchronize()
        prof = np.zeros(len(PHASES), dtype=np.int64)
        smid = np.zeros(MAX_BLOCKS, dtype=np.uint32)
        err = lib.jprof_read(prof.ctypes.data, smid.ctypes.data)
        if err:
            raise SystemExit(f"{name}: reading back failed, CUDA {err}")
        lanes = realform.group_layout(n)["lanes"] if route == "group" else 1
        warps = -(-b // (32 // lanes))
        blocks = -(-warps * 32 // THREADS[route])
        sms = np.bincount(smid[:min(blocks, MAX_BLOCKS)],
                          minlength=props.multi_processor_count)
        wps = sms.max() * (THREADS[route] // 32) / 4
        print(f"\n{name} n={n} B={b} sweeps={sweeps}, {lanes} lane(s) a "
              f"matrix: {resources(log, name + '_kernel', n)}")
        print(f"  {blocks} blocks of {THREADS[route]} threads on "
              f"{int((sms > 0).sum())} of {props.multi_processor_count} SMs "
              f"(first {min(blocks, MAX_BLOCKS)} blocks), at most "
              f"{int(sms.max())} blocks = {wps:g} warps per scheduler on one "
              f"SM, if all were resident at once")
        total = int(prof.sum())
        print(f"  thread 0 of block 0: {total} clocks "
              f"({total / ghz * 1e-3:.2f} us at the card's highest SM "
              f"clock, {ghz:.3f} GHz)")
        for k, phase in enumerate(PHASES):
            if prof[k]:
                print(f"    {phase:20s} {int(prof[k]):9d} clocks "
                      f"{100 * prof[k] / total:5.1f}%  "
                      f"{prof[k] / sweeps:9.1f} per sweep")

    for kind, b in (("amp", args.amp_b), ("grad", args.grad_b)):
        for route in routes:
            reading(kind, b, route)

    # milliseconds per launch of the uninstrumented builds
    def timed_fn(kind, route, b):
        tensors = inputs(kind, b)
        fn = entry(without[kind][0], f"sym_jacobi_{kind}{SUFFIX[route]}",
                   len(tensors))
        return lambda: call(fn, tensors, b)

    print()
    timed = [("launch_floor (empty kernel, the package's wrapper)",
              lambda: cuda_jacobi.launch_floor("cuda"))]
    for route in routes:
        for kind, b in (("amp", args.amp_b), ("grad", args.grad_b)):
            timed.append((f"sym_jacobi_{kind}{SUFFIX[route]} B={b}",
                          timed_fn(kind, route, b)))
    for label, fn in timed + timed[::-1]:
        print(f"{label}: host-paced {time_ms(fn):.5f} ms, card-paced "
              f"{time_ms(fn, behind_spin=True):.5f} ms per launch")

    if args.sweep:
        print(f"\ncard-paced ms per launch at n={n} (each the smaller of "
              f"two readings, taken one, group, group, one): one thread / "
              f"group")
        for b in SWEEP_BATCHES:
            cells = []
            for kind in ("amp", "grad"):
                fns = [timed_fn(kind, r, b) for r in ("one", "group")]
                ms = [[], []]
                for i in (0, 1, 1, 0):
                    ms[i].append(time_ms(fns[i], reps=50, behind_spin=True))
                cells.append(f"{kind} " + " / ".join(f"{min(x):.5f}"
                                                     for x in ms))
            print(f"  B={b:6d}: " + "; ".join(cells))


if __name__ == "__main__":
    main()
