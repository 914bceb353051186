"""Hold the port's two critic kernels against their plain versions on one
CUDA card, and time them: the short check to run after an edit of
csrc/critic_train*.cu, before the whole of chip_smoke.py.

    python3 tools/check_critic.py [--agents 1024] [--steps 500] [--time]
        [--parent DIR]

Run from the repository root.  Builds csrc/*.cu (utils/build.py) and
prints the compiler's report for the critic kernels.  For each shape
(h, T, A) it runs each kernel that takes the shape (the float32 kernel,
``fast_dot=False``, takes all; the bf16 one h <= 111) and
``critic_train_plain`` with the same ``fast_dot`` from the same inputs at
iters 1 and 7 and prints, per parameter block (W1, W2, w3), the max abs
difference of theta and of mu (with zero moments mu = 0.1 g after one
iteration, so this reads each gradient block) and the share of elements
past atol 2e-6 + rtol 1e-5.  ``--time`` adds CUDA-event times of both
kernels at (h=100, --steps, --agents), 200 iterations, in turns.
``--parent DIR`` builds csrc/critic_train.cu of DIR's
code_robchar_tpu_torch (a checkout of another commit, e.g. from ``git
archive``) on its own and, with ``--time``, times its float32 kernel and
this tree's in turns parent, tree, tree, parent, with the value loss
mean((v - ret)^2) of each after the 200 iterations.  Exits non-zero when
a kernel's gradient is off by more than 1e-3 of its block's scale (a
layout fault, not rounding) or the float32 kernel is past the bars of
chip_smoke.py phase 7 (an element beyond 2 lr iters, or more than 1e-5
of them past atol 2e-6 + rtol 1e-5).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _inputs(a_cnt, t_len, d, h, seed, dev):
    from code_robchar_tpu_torch.ops import critic

    rng = np.random.default_rng(seed)
    p = critic.n_params(d + 1, h)
    f32 = dict(dtype=torch.float32, device=dev)
    theta = torch.as_tensor(rng.normal(0, 0.2, (a_cnt, p)), **f32)
    obs = torch.as_tensor(rng.normal(size=(a_cnt, t_len, d)), **f32)
    rets = torch.as_tensor(rng.normal(size=(a_cnt, t_len)), **f32)
    zero = torch.zeros_like(theta)
    count = torch.zeros(a_cnt, dtype=torch.int32, device=dev)
    return theta, zero, zero.clone(), count, obs, rets


def _parent_entry(parent, build):
    """The C entry critic_train of DIR's csrc/critic_train.cu, built on its
    own into build/check_critic/."""
    out_dir = os.path.join(build.BUILD_DIR, "check_critic")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "critic_train_parent.so")
    csrc = os.path.join(parent, "code_robchar_tpu_torch", "csrc")
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc,
                          "-shared", "-o", so,
                          os.path.join(csrc, "critic_train.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(out.stdout + out.stderr)
    for line in (out.stdout + out.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "stack")):
            print(f"  parent nvcc: {line.strip()}")
    fn = ctypes.CDLL(so).critic_train
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [_p] * 10 + [_i] * 4 + [_f] * 9 + [_i] * 2 + [_p]
    fn.restype = ctypes.c_int
    return fn


def _run_parent(fn, inputs, h, iters, lr):
    from code_robchar_tpu_torch.ops import critic

    theta, mu, nu, count, obs, rets = inputs
    a_cnt, t_len, d = obs.shape
    outs = (torch.empty_like(theta), torch.empty_like(mu),
            torch.empty_like(nu), torch.empty_like(count))
    lb1, lb2 = critic._log_betas(0.9, 0.999)
    err = fn(*(x.data_ptr() for x in (*inputs, *outs)), d + 1, h, t_len,
             iters, lr, 0.9, 0.1, 0.999, 0.001, lb1, lb2, 1e-8, 2.0 / t_len,
             a_cnt, obs.device.index or 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"parent kernel: CUDA error {err}")
    return outs


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from code_robchar_tpu_torch.ops import critic
    from code_robchar_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    res = build.build()
    print(f"build: {res.seconds:.2f} s (cached={res.cached})")
    show = False
    for line in res.log.splitlines():
        if "Function properties" in line or "Compiling entry" in line:
            show = "critic" in line
        if show and any(w in line for w in ("Function", "registers", "spill",
                                            "stack", "warning")):
            print(f"  nvcc: {line.strip()}")

    dev = torch.device("cuda")
    bad = False
    for h, t_len, a_cnt, d in ((20, 37, 3, 6), (30, 64, 50, 8),
                               (16, 300, 5, 4), (30, 300, 130, 8),
                               (157, 129, 132, 8), (100, 500, 8, 8),
                               (100, args.steps, args.agents, 8)):
        inputs = _inputs(a_cnt, t_len, d, h, seed=h + t_len, dev=dev)
        n1, n2 = (d + 1) * h, (h + 1) * h
        blocks = {"W1": slice(0, n1), "W2": slice(n1, n1 + n2),
                  "w3": slice(n1 + n2, None)}
        for fast in (False, True):
            if fast and h > critic.MAX_H_BF16:
                continue
            for iters in (1, 7):
                kw = dict(h=h, iters=iters, lr=1e-3, fast_dot=fast)
                got = critic.critic_train_cuda(*inputs, **kw)
                want = critic.critic_train_plain(*inputs, **kw)
                torch.cuda.synchronize()
                parts = []
                over_all = 0
                for name, sl in blocks.items():
                    scale = float(want[1][:, sl].abs().max())
                    e_mu = float((got[1][:, sl] - want[1][:, sl]).abs().max())
                    e_th = float((got[0][:, sl] - want[0][:, sl]).abs().max())
                    over = float(((got[0][:, sl] - want[0][:, sl]).abs()
                                  > 2e-6 + 1e-5 * want[0][:, sl].abs()
                                  ).double().mean())
                    parts.append(f"{name} mu {e_mu:.2e} (scale {scale:.2e}) "
                                 f"theta {e_th:.2e} past {over:.2e}")
                    if iters == 1 and not e_mu <= 1e-3 * scale:
                        bad = True
                if not fast:
                    errs = [float((g - w).abs().max())
                            for g, w in zip(got[:3], want[:3])]
                    over_all = sum(int(((g - w).abs() > 2e-6 + 1e-5
                                        * w.abs()).sum())
                                   for g, w in zip(got[:3], want[:3]))
                    if max(errs) > 2e-3 * iters or \
                            over_all > 1e-5 * 3 * got[0].numel():
                        bad = True
                print(f"{'bf16' if fast else 'float32'} h={h} T={t_len} "
                      f"A={a_cnt} d={d} iters={iters}: " + "; ".join(parts)
                      + f"; count equal {torch.equal(got[3], want[3])}"
                      + ("" if fast else f"; elements past the bars "
                         f"{over_all}"))

    if args.time:
        inputs = _inputs(args.agents, args.steps, 8, 100, seed=1, dev=dev)
        kw = dict(h=100, iters=200, lr=1e-3)
        for label, fast in (("float32", False), ("bf16", True),
                            ("bf16", True), ("float32", False)):
            ms = _time_ms(lambda: critic.critic_train_cuda(
                *inputs, fast_dot=fast, **kw), 2)
            print(f"timing {label} kernel A={args.agents} T={args.steps} "
                  f"h=100 iters=200: {ms:.3f} ms")
        if args.parent:
            parent = _parent_entry(args.parent, build)
            runs = {
                "parent": lambda: _run_parent(parent, inputs, **kw),
                "tree": lambda: critic.critic_train_cuda(*inputs, **kw)}
            ms = {"parent": [], "tree": []}
            for tag in ("parent", "tree", "tree", "parent"):
                ms[tag].append(_time_ms(runs[tag], 2))
            losses = {tag: critic.value_loss(run()[0], inputs[4], inputs[5],
                                             100)
                      for tag, run in runs.items()}
            print(f"float32 kernel A={args.agents} T={args.steps} h=100 "
                  f"iters=200, ms in turns parent, tree, tree, parent: "
                  f"parent {ms['parent']}, tree {ms['tree']}; value loss "
                  f"after: parent {losses['parent']:.6f}, tree "
                  f"{losses['tree']:.6f}")
    if bad:
        raise SystemExit("a gradient block is off beyond rounding")


if __name__ == "__main__":
    main()
