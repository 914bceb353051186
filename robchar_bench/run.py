"""Run one cell of the benchmark once and print its result line.

    python3 -m robchar_bench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and ``checks``, each
number the reference compared beside its limit.  The checks are also the
last lines of standard error.

Exits 2 without a result where there is no CUDA device or fewer than the
cell asks for, and 3 where, once the window has closed, a module of JAX or
of the JAX package is loaded in this process.  The program's kernels build
into its own directory in the checkout (``code_robchar_tpu_torch/build``);
the caches of torch's extension builder and of Triton are pointed inside
the checkout too, so that only a checkout's first run builds.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: modules that no process of the benchmark may hold (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "code_robchar_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = _args(argv)
    root = os.getcwd()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, ".bench_cache", sub)

    import torch

    from robchar_bench import harness

    bench = harness.load_json(harness.bench_path(root))
    spec = harness.cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _err(f"{args.workload} needs {chips} CUDA device(s): "
             f"torch.cuda.is_available() {torch.cuda.is_available()}, "
             f"device_count {torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0, log=_err)
    bad = harness.forbidden_modules(sys.modules, FORBIDDEN)
    if bad:
        _err(f"forbidden modules loaded in the benchmark process: {bad}")
        return 3
    for name, c in result["checks"].items():
        _err(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
