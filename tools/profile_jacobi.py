"""Where the clocks of the Jacobi kernels go, phase by phase, and how much
of the card a launch occupies, on one CUDA card.

    python3 tools/profile_jacobi.py [--n 7] [--routes one,group]
        [--amp-b 9216] [--grad-b 1024] [--sweep]
    python3 tools/profile_jacobi.py --herm [--n 7] [--parent DIR]
        [--mc-chunks 3]
    python3 tools/profile_jacobi.py --eigh 1024,9216,131072 [--n 7]

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

With ``--herm`` it does the same for the MC path's Hermitian kernel
(csrc/herm_jacobi_fidelity.cu, one thread per matrix) at n = 7 and the
path's chunk, B = mc/engine.KERNEL_CHUNK = 131072: registers, clocks by phase, the card's
occupancy (blocks per SM from the registers, waves of 128-thread
blocks), and the share of pivots whose angle chain left the fast paths'
ranges and took the exact one (a ``// @fallback`` line in
csrc/jacobi_common.cuh becomes a count), on random Hermitian matrices
and on ``--mc-chunks`` chunks spread over the MC headline sweep itself
(N=7, 10,000 controllers x 11 noise levels x 100 bootreps, seed 0).
``--parent DIR`` also builds the kernel from DIR's
code_robchar_tpu_torch/csrc (a checkout of another commit, e.g. from
``git archive``) and holds the two bit for bit on the same inputs (the
share of equal outputs, and the largest difference where they differ),
then times both card-paced in turns parent, tree, tree, parent.

``--eigh B,...`` times one batched torch.linalg.eigh of B random real
symmetric float32 n x n matrices at each batch: the library yardstick of
the zoo kernels at the batches their paths launch.

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
__device__ unsigned long long g_exact[2];   // pivots, warps' pivots
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


# one count a pivot on the exact path, one a warp's pivot with any
FALLBACK = ("{ atomicAdd(&g_exact[0], 1ull); "
            "if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) "
            "atomicAdd(&g_exact[1], 1ull); }")

EXACT_READER = """
extern "C" int jprof_exact(unsigned long long* counts) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(counts, g_exact, sizeof(g_exact));
  unsigned long long zero[2] = {0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_exact, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def _markers(src: str) -> str:
    def marker(match):
        k = PHASES.index(match.group(3).strip())
        macro = "JPROF_ST" if match.group(2) else "JPROF"
        tail = " jprof_end(st);" if PHASES[k] == "store" else ""
        return f"{match.group(1)}{macro}({k});{tail}"

    src = re.sub(r"^(\s*)// @fallback$", lambda m: m.group(1) + FALLBACK, src,
                 flags=re.M)
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


def instrument_herm(src: str) -> str:
    """herm_jacobi_fidelity.cu with the readings compiled in: its state
    gains the sums, the state's declaration starts them, every marker
    reads the clock, and C entries read the sums and the exact-path
    counts back."""
    member = "  float vi[2][N];              // rows in, out of V (imaginary)\n"
    if src.count(member) != 1:
        raise RuntimeError("herm_jacobi_fidelity.cu: anchor not found once")
    src = src.replace(member, member + "  long long pacc[JPROF_PHASES];\n"
                      "  long long plast;\n")
    src, n = re.subn(r"^(\s*Herm<N> st;)$", r"\1 jprof_begin(st);", src,
                     flags=re.M)
    if n != 1:
        raise RuntimeError(f"expected the state declared once, found {n}")
    return _markers(src) + READER + EXACT_READER


def build_herm(build, csrc, tag, instrumented):
    """Start nvcc on a copy of ``csrc``'s Hermitian kernel and header under
    build/profile_jacobi/<tag>/; (library path, process)."""
    out_dir = os.path.join(build.BUILD_DIR, "profile_jacobi", tag)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "jacobi_common.cuh")) as f:
        header = f.read()
    with open(os.path.join(csrc, "herm_jacobi_fidelity.cu")) as f:
        src = f.read()
    with open(os.path.join(out_dir, "jacobi_common.cuh"), "w") as f:
        f.write(instrument_header(header) if instrumented else header)
    cu = os.path.join(out_dir, "herm_jacobi_fidelity_prof.cu")
    with open(cu, "w") as f:
        f.write(instrument_herm(src) if instrumented else src)
    return cu[:-3] + ".so", subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", cu[:-3] + ".so",
         cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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


def registers(log: str, kernel: str, n: int) -> int:
    """The registers a thread of ``kernel<n>`` takes, from nvcc's report."""
    m = re.search(r"Used (\d+) registers", resources(log, kernel, n))
    return int(m.group(1)) if m else 0


def blocks_per_sm(regs: int, threads: int, props) -> int:
    """Blocks of ``threads`` threads that fit on one SM by their registers
    (256-register allocation units per warp) and the SM's warp and block
    limits."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    regs_sm = getattr(props, "regs_per_multiprocessor", 65536)
    threads_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    by_regs = regs_sm // (warps * per_warp) if regs else 32
    return max(0, min(32, threads_sm // threads, by_regs))


def herm_main(args, build, cuda_jacobi, realform, props, ghz):
    """The --herm run (module docstring)."""
    from code_robchar_tpu_torch.mc import engine

    n, b = args.n, engine.KERNEL_CHUNK
    sweeps = realform._sweeps_for(torch.float32, n)
    f32 = dict(dtype=torch.float32, device="cuda")
    procs = {"readings": build_herm(build, build.CSRC_DIR, "herm_readings",
                                    True),
             "tree": build_herm(build, build.CSRC_DIR, "herm_tree", False)}
    if args.parent:
        procs["parent"] = build_herm(
            build, os.path.join(args.parent, "code_robchar_tpu_torch",
                                "csrc"), "herm_parent", False)
    libs = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        libs[tag] = (ctypes.CDLL(so), log)
        fn = entry(libs[tag][0], "herm_jacobi_fidelity", 4)
        regs = registers(log, "herm_jacobi_fidelity_kernel", n)
        print(f"herm_jacobi_fidelity ({tag}) n={n}: "
              f"{resources(log, 'herm_jacobi_fidelity_kernel', n)}")
        if tag == "tree":
            for m in range(2, 11):
                print(f"  n={m}: "
                      f"{resources(log, 'herm_jacobi_fidelity_kernel', m)}")
        per_sm = blocks_per_sm(regs, 128, props)
        if per_sm:
            wave = per_sm * props.multi_processor_count
            print(f"  {per_sm} blocks of 128 threads per SM by registers "
                  f"({per_sm} warps per scheduler), {wave * 128} matrices a "
                  f"wave: B={b} takes {b / (wave * 128):.2f} waves")

    rng = np.random.default_rng(b)
    a = rng.normal(size=(n, n, b))
    z = rng.normal(size=(n, n, b))
    random = (torch.as_tensor((a + a.transpose(1, 0, 2)) / 2, **f32),
              torch.as_tensor((z - z.transpose(1, 0, 2)) / 2, **f32),
              torch.as_tensor(rng.uniform(1, 5, b), **f32))
    cases = [("random Hermitian", random)]
    if args.mc_chunks:
        cases += [(f"MC headline chunk {i} of {args.mc_chunks}", c)
                  for i, c in enumerate(mc_chunks(args.mc_chunks))]

    def run(tag, ar, ai, t):
        fid = torch.empty(ar.shape[-1], **f32)
        err = entry(libs[tag][0], "herm_jacobi_fidelity", 4)(
            ar.data_ptr(), ai.data_ptr(), t.data_ptr(), fid.data_ptr(),
            ar.shape[0], 0, ar.shape[0] - 1, sweeps, cuda_jacobi.EPS,
            ar.shape[-1], 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{tag}: CUDA error {err}")
        return fid

    lib = libs["readings"][0]
    lib.jprof_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.jprof_exact.argtypes = [ctypes.c_void_p]
    pivots = n * (n - 1) // 2
    for label, (ar, ai, t) in cases:
        bb = ar.shape[-1]
        run("readings", ar, ai, t)
        counts = np.zeros(2, dtype=np.uint64)
        lib.jprof_exact(counts.ctypes.data)
        run("readings", ar, ai, t)
        prof = np.zeros(len(PHASES), dtype=np.int64)
        smid = np.zeros(MAX_BLOCKS, dtype=np.uint32)
        if lib.jprof_read(prof.ctypes.data, smid.ctypes.data):
            raise SystemExit("reading back failed")
        lib.jprof_exact(counts.ctypes.data)
        total = bb * sweeps * pivots
        warp_total = -(-bb // 32) * sweeps * pivots
        print(f"\n{label}, n={n} B={bb} sweeps={sweeps}: pivots on the "
              f"exact angle path {int(counts[0])} of {total} "
              f"({counts[0] / total:.3e}); pivots of a warp with one "
              f"{int(counts[1])} of {warp_total} "
              f"({counts[1] / warp_total:.3e})")
        tot = int(prof.sum())
        print(f"  thread 0 of block 0: {tot} clocks ({tot / ghz * 1e-3:.2f} "
              f"us at {ghz:.3f} GHz)")
        for k, phase in enumerate(PHASES):
            if prof[k]:
                print(f"    {phase:20s} {int(prof[k]):9d} clocks "
                      f"{100 * prof[k] / tot:5.1f}%  "
                      f"{prof[k] / sweeps:9.1f} per sweep")
        if "parent" in libs:
            got, want = run("tree", ar, ai, t), run("parent", ar, ai, t)
            torch.cuda.synchronize()
            same = got.view(torch.int32) == want.view(torch.int32)
            diff = (got - want).abs()
            print(f"  tree vs parent: bit-equal {int(same.sum())} of {bb} "
                  f"({float(same.float().mean()):.6f}); max |diff| "
                  f"{float(diff.max()):.3e}, finite "
                  f"{bool(torch.isfinite(got).all())}")

    if "parent" in libs:
        ar, ai, t = random
        fns = {tag: (lambda tag=tag: run(tag, ar, ai, t))
               for tag in ("parent", "tree")}
        ms = {"parent": [], "tree": []}
        for tag in ("parent", "tree", "tree", "parent"):
            ms[tag].append(time_ms(fns[tag], reps=50, behind_spin=True))
        print(f"\ncard-paced ms per launch at n={n} B={b} (parent, tree, "
              f"tree, parent): parent {ms['parent']}, tree {ms['tree']}; "
              f"min {min(ms['parent']):.5f} -> {min(ms['tree']):.5f}")
    else:
        ar, ai, t = random
        print(f"\ncard-paced ms per launch at n={n} B={b}: "
              f"{time_ms(lambda: run('tree', ar, ai, t), 50, True):.5f}")


def eigh_ms(mats):
    """(ms, backend) of one batched torch.linalg.eigh on ``mats`` (B, n, n),
    the library yardstick of the Jacobi kernels (the eigendecomposition
    only), the smaller of two timed calls after a warm one.  cuSOLVER's
    batched eigh refuses large batches of small matrices; the call then
    runs with MAGMA."""
    try:
        return min(time_ms(lambda: torch.linalg.eigh(mats), 3)
                   for _ in range(2)), "cusolver"
    except torch.linalg.LinAlgError:
        torch.backends.cuda.preferred_linalg_library("magma")
        try:
            return min(time_ms(lambda: torch.linalg.eigh(mats), 1)
                       for _ in range(2)), "magma"
        finally:
            torch.backends.cuda.preferred_linalg_library("default")


def eigh_main(n, batches):
    """The --eigh run: batched torch.linalg.eigh of B random real symmetric
    float32 n x n matrices (the zoo kernels' matrices) at each batch."""
    for b in batches:
        a = torch.randn((b, n, n), dtype=torch.float32, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(b))
        ms, backend = eigh_ms(((a + a.transpose(1, 2)) / 2).contiguous())
        print(f"torch.linalg.eigh n={n} B={b} float32 ({backend}, "
              f"eigendecomposition only): {ms:.4f} ms")


def mc_chunks(count):
    """The Hermitian kernel's inputs (ar, ai, t) of ``count`` launches of
    the MC headline sweep spread from its first to its last (the first
    chunks hold the noiseless level, whose matrices are real), taken from
    the engine's call."""
    from code_robchar_tpu_torch.mc import engine
    from code_robchar_tpu_torch.ops import chain, cuda_jacobi, prng

    n, n_ctrl, n_noise, bootreps = 7, 10_000, 11, 100
    chunks = -(-n_ctrl * n_noise * bootreps // engine.KERNEL_CHUNK)
    # spread over the sweep: the first chunks hold the noiseless level
    wanted = set(np.linspace(0, chunks - 1, count).round().astype(int))
    rng = np.random.default_rng(0)
    ctrl = np.column_stack([rng.uniform(-10, 10, (n_ctrl, n)),
                            rng.uniform(0, 30, n_ctrl)]).astype(np.float32)
    noises = np.linspace(0, 0.1, n_noise).astype(np.float32)
    taken, calls = [], [0]
    kernel = cuda_jacobi.fidelity_herm

    def take(ar, ai, t, *rest):
        if calls[0] in wanted:
            taken.append((ar.clone(), ai.clone(), t.clone()))
        calls[0] += 1
        return kernel(ar, ai, t, *rest)

    cuda_jacobi.fidelity_herm = take
    try:
        engine.mc_metric_sweep(chain.xx_hamiltonian_real(
            n, dtype=torch.float32), ctrl, noises, prng.key(1), bootreps, 0,
            6, complex_offdiag=True, alpha=0.05, device="cuda")
    finally:
        cuda_jacobi.fidelity_herm = kernel
    return taken


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=7)
    ap.add_argument("--routes", default="one,group")
    ap.add_argument("--amp-b", type=int, default=9216)
    ap.add_argument("--grad-b", type=int, default=1024)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--herm", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--mc-chunks", type=int, default=3)
    ap.add_argument("--eigh", default=None)
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
    if args.herm:
        herm_main(args, build, cuda_jacobi, realform, props, ghz)
        return
    if args.eigh:
        eigh_main(args.n, [int(b) for b in args.eigh.split(",")])
        return
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
