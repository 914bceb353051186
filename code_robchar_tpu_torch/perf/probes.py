"""The measurement probes on the card (counterpart of the ALU probe of
artifacts/perf/roofline.py §4, :246-301, and of
artifacts/perf/tanh_microbench.py):

    python -m code_robchar_tpu_torch.perf.probes

- ``alu_sweep``: csrc/alu_probe.cu at B = 2^19 lanes of the reference's
  input (symmetric normal 7 x 7 matrices in the lanes layout, times 1e-3),
  streams 1, 4 and 8, K = 1024, 2048 and 4096 chain steps;
- ``tanh_sweep``: csrc/tanh_probe.cu on a (512, 128) standard normal array
  (``prng.normal(prng.key(0))``, the reference's draw), ops mul, tanh and
  rational, K = 1024 and 8192.

Each time is CUDA events around ``REPS`` launches enqueued behind a ~30 ms
spin of the card (card-paced: the launches run back to back), best of two.
The slope of time over K is the marginal cost of one step: for the ALU
probe in ns per step per 1024 lanes and in cycles at the SM clock that
``nvidia-smi --query-gpu=clocks.sm`` reads right after the sweep (a
multiply-add step is two operations, so per op is half); for the tanh
probe in ps per element per step.  Prints one JSON line per probe under
the reference's keys, after the card's name and power limit.  Needs a
CUDA card; the kernels build at first use (utils/build.py).
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from code_robchar_tpu_torch.ops import prng, probes

ALU_LANES = 1 << 19
ALU_KS = (1024, 2048, 4096)
TANH_SHAPE = (512, 128)
TANH_KS = (1024, 8192)
#: launches timed together (roofline.py:171)
REPS = 8
#: cycles of the spin the timed launches are enqueued behind (~30 ms)
SPIN_CYCLES = 50_000_000


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sm_clock_hz() -> float:
    """The SM clock nvidia-smi reads now, in Hz (first card)."""
    return float(_smi("clocks.sm").splitlines()[0].split()[0]) * 1e6


def card_ms(fn, reps: int = REPS, trials: int = 2) -> float:
    """Milliseconds per call of ``fn``, card-paced: ``reps`` calls enqueued
    behind a spin, between two CUDA events; the best of ``trials``."""
    fn()
    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _slope(times: dict) -> float:
    ks = np.array(sorted(times), dtype=float)
    return float(np.polyfit(ks, [times[k] for k in sorted(times)], 1)[0])


def alu_input(device) -> torch.Tensor:
    return torch.as_tensor(probes.reference_alu_input(ALU_LANES),
                           device=device)


def tanh_input(device) -> torch.Tensor:
    return prng.normal(prng.key(0), TANH_SHAPE, torch.float32).to(device)


def alu_sweep(x: torch.Tensor) -> dict:
    """The ALU probe's K-sweep on x (rows, B): per stream count, the ms of
    a launch by K and the marginal cost of a step."""
    lanes = x.shape[1]
    times = {s: {k: card_ms(lambda s=s, k=k: probes.alu_probe(x, s, k))
                 for k in ALU_KS} for s in probes.ALU_STREAMS}
    clock = sm_clock_hz()
    out = {}
    for s, by_k in times.items():
        slope = _slope(by_k) * 1e-3                  # s per chain step
        per_1024 = slope / (lanes / 1024)
        out[s] = {"times_ms_by_K": {str(k): v for k, v in by_k.items()},
                  "marginal_ns_per_step_per_1024": per_1024 * 1e9,
                  "marginal_cycles_per_fma_per_1024": per_1024 * clock,
                  "marginal_cycles_per_op_per_1024": per_1024 * clock / 2,
                  "sm_clock_hz": clock}
    return out


def tanh_sweep(x: torch.Tensor) -> dict:
    """The tanh probe's K-sweep on x: per op, the ms of a launch by K and
    the marginal ps per element per step."""
    out = {}
    for op in probes.TANH_OPS:
        by_k = {k: card_ms(lambda op=op, k=k: probes.tanh_probe(x, op, k))
                for k in TANH_KS}
        marg = (by_k[TANH_KS[-1]] - by_k[TANH_KS[0]]) * 1e-3 \
            / (TANH_KS[-1] - TANH_KS[0])
        out[op] = {"times_ms_by_K": {str(k): v for k, v in by_k.items()},
                   "marginal_ps_per_elem_per_iter":
                       marg / x.numel() * 1e12}
    base = out["mul"]["marginal_ps_per_elem_per_iter"]
    for op in out:
        out[op]["in_mul_units"] = out[op]["marginal_ps_per_elem_per_iter"] \
            / base
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the probes need a CUDA card")
    dev = torch.device("cuda")
    print(_smi("name,power.limit"))
    for s, res in alu_sweep(alu_input(dev)).items():
        print(json.dumps({f"alu_probe_{s}_streams": res}))
    for op, res in tanh_sweep(tanh_input(dev)).items():
        print(json.dumps({f"tanh_probe_{op}": res}))


if __name__ == "__main__":
    main()
