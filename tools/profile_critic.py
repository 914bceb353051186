"""Where a critic kernel's clocks go, phase by phase, on one CUDA card.

    python3 tools/profile_critic.py [--f32 [--parent DIR]] [--agents 1024]
        [--steps 500] [--iters 200]

Run from the repository root.  csrc/critic_train_bf16.cu (the default) and
csrc/critic_train.cu (``--f32``, the float32 kernel) mark the start of each
phase with a comment line ``// @phase <name>``; a name may recur (every
block barrier is ``barriers``).  This script writes a copy of the source
in which every such line reads clock64() on lane 0 of each warp and adds
the clocks since the previous reading to the phase that was running (in
shared memory; block 0 writes its sums out at the end), builds the copy
with nvcc into the package's build directory, runs it once warm at
(--agents, --steps, h = 100, --iters), and prints the launch's CUDA-event
time, the registers of the instrumented build, and per phase the share of
each warp's clocks and warp 0's clocks per iteration.  ``--parent DIR``
(with ``--f32``) does the same, in the same process, for the float32
kernel of DIR's code_robchar_tpu_torch (a checkout of another commit, e.g.
from ``git archive``): where that source has no markers (the kernel
before its register-tiled redesign), PARENT_MARKS places them before its
phases' first lines.  The readings cost a few percent (the time printed
here against
tools/check_critic.py --time) and may move the compiler's schedule:
read the shares, not the absolute clocks.
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
WARPS = 8
INFRA = """
  __shared__ long long sprof[%d][%d];
  if (threadIdx.x < %d) (&sprof[0][0])[threadIdx.x] = 0;
  long long plast = clock64();
  int pcur = 0;
#define PROF(k) do { if ((threadIdx.x & 31) == 0) { \\
    long long c_ = clock64(); sprof[threadIdx.x >> 5][pcur] += c_ - plast; \\
    plast = c_; pcur = k; } } while (0)
""" % (WARPS, MAX_PHASES, WARPS * MAX_PHASES)
#: where the phases of the float32 kernel before its register-tiled
#: redesign (csrc/critic_train.cu) start: (the start of its first line,
#: the phase); every block barrier inside the iteration loop is
#: ``barriers``
PARENT_MARKS = (
    ("      for (int i = tid; i < kRows * d1; i += nthr) {", "X tile"),
    ("      // forward: h1 = tanh(X W1)", "forward layer 1"),
    ("      product(kRows, h, h + 1, H1, ldh", "forward layer 2"),
    ("      // v = [h2 1] w3, one warp per row", "v, dv"),
    ("      // g3 += [h2 1]^T dv", "g3"),
    ("      // dz2 = dv w3^T (1 - h2^2)", "dz2"),
    ("      // g2 += [h1 1]^T dz2", "g2"),
    ("      // dz1 = (dz2 W2[:h]^T)(1 - h1^2)", "dz1"),
    ("      // g1 += X^T dz1", "g1"),
    ("    // Adam at t = count + it + 1", "Adam"))
LOOP = "  for (int it = 0; it < hp.iters; ++it) {\n"


def mark_parent(src: str) -> str:
    """The float32 kernel from before its register-tiled redesign with
    `// @phase` lines before its phases and before every barrier of its
    iteration loop."""
    if "// @phase" in src:
        return src
    for start, name in PARENT_MARKS:
        if src.count(start) != 1:
            raise RuntimeError(f"parent source: expected once: {start!r}")
        indent = start[:len(start) - len(start.lstrip())]
        src = src.replace(start, f"{indent}// @phase {name}\n{start}")
    head, loop = src.split(LOOP)
    loop = re.sub(r"^(\s+)__syncthreads\(\);$",
                  lambda m: f"{m.group(1)}// @phase barriers\n{m.group(0)}",
                  loop, flags=re.M)
    return head + LOOP + loop


def instrument(src: str, entry: str):
    """(instrumented source, phase names).  Phase 0 is what runs before the
    first marker (set-up) and after the last one of an iteration; a name
    that recurs keeps its first index.  ``entry`` is the C entry's name;
    the copy's is ``entry``_prof."""
    names = ["set-up"]

    def marker(match):
        name = match.group(2).strip()
        if name not in names:
            names.append(name)
        return f"{match.group(1)}PROF({names.index(name)});"

    src = re.sub(r"^(\s*)// @phase (.*)$", marker, src, flags=re.M)
    if len(names) < 2 or len(names) > MAX_PHASES:
        raise RuntimeError(f"{len(names) - 1} phases found")

    def once(pattern, new):
        nonlocal src
        src, n = re.subn(pattern, new, src)
        if n != 1:
            raise RuntimeError(f"expected once in the source: {pattern!r}")

    once(r"Hyper hp\) \{", "Hyper hp, long long* prof) {")
    once(r"(const int64_t rbase = static_cast<int64_t>\(agent\) \* T;\n)",
         lambda m: m.group(1) + INFRA)
    once(r"\n(  if \(tid == 0\) count_out\[agent\] = c0 \+ hp\.iters;)",
         lambda m: "\n  PROF(0);\n  __syncthreads();\n"
         f"  if (agent == 0 && threadIdx.x < {WARPS * MAX_PHASES}) "
         "prof[threadIdx.x] = (&sprof[0][0])[threadIdx.x];\n" + m.group(1))
    once(r"hp\);\n  return static_cast<int>\(cudaGetLastError\(\)\);",
         "hp, prof);\n  return static_cast<int>(cudaGetLastError());")
    once(r"int A, int device,(\s*)void\* stream\) \{",
         lambda m: f"int A, int device,{m.group(1)}void* stream, "
         "long long* prof) {")
    once(rf'extern "C" int {entry}\(', f'extern "C" int {entry}_prof(')
    return src, names


def profile(tag, src, entry, args, build):
    """Build the instrumented ``src`` and print its readings."""
    from code_robchar_tpu_torch.ops import critic

    src, names = instrument(src, entry)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, f"{entry}_{tag}_prof.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          build.CSRC_DIR, "-shared", "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(out.stdout + out.stderr)
    print(f"\n{tag}: {entry} with the readings")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")
    fn = getattr(ctypes.CDLL(so), f"{entry}_prof")
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
    prof = torch.zeros(WARPS * MAX_PHASES, dtype=torch.int64, device="cuda")
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
    clocks = prof.cpu().numpy().reshape(WARPS, MAX_PHASES)[:, :len(names)]
    total = clocks.sum(1)
    print(f"instrumented launch A={a_cnt} T={t_len} h={h} iters="
          f"{args.iters}: {start.elapsed_time(end):.3f} ms; block 0: "
          f"{total[0] / args.iters:.0f} clocks per iteration")
    print(f"{'phase':38s} share of each warp's clocks (%), warps 0-7"
          f"{'':6s} warp 0 clocks/iter")
    for k, name in enumerate(names):
        shares = " ".join(f"{100 * clocks[w, k] / total[w]:5.1f}"
                          for w in range(WARPS))
        print(f"{name:38s} {shares} {clocks[0, k] / args.iters:12.0f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.parent and not args.f32:
        raise SystemExit("--parent profiles the float32 kernel: add --f32")
    from code_robchar_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    entry = "critic_train" if args.f32 else "critic_train_bf16"
    with open(os.path.join(build.CSRC_DIR, f"{entry}.cu")) as f:
        profile("tree", f.read(), entry, args, build)
    if args.parent:
        with open(os.path.join(args.parent, "code_robchar_tpu_torch", "csrc",
                               "critic_train.cu")) as f:
            profile("parent", mark_parent(f.read()), entry, args, build)


if __name__ == "__main__":
    main()
