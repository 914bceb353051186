"""Work of kernel 4 (csrc/actor_env_rollout.cu): one agent's env step of
the whole-trajectory PPO rollout.

Operations: the hand count of artifacts/perf/roofline.py:93-99, frozen from
chip_smoke.py:493-505 (``_amp_flops``, ``_rollout_step_flops``): the actor
MLP d -> h -> h -> d at 2 operations a multiply-add, the 2h tanh, the
symmetric Jacobi sweeps carrying two eigenvector rows with the amplitude,
and ~30 of env bookkeeping.  Bytes, for A agents and T steps, float32
(chip_smoke.py:1642-1644): the folded actor weights and log_std once, the
noise streams (eps, diagonal, couplings), the trajectory (a, obs2, fid),
the carries in and out, the drift, and two bool flags a step."""

from robchar_bench.counts.herm_jacobi import pairs
from robchar_bench.counts.sym_grad import rot_flops


def amp_flops(n: int, sweeps: int) -> int:
    return sweeps * pairs(n) * rot_flops(n, 2) + 6 * n + 2


def step_flops(n: int, h: int, sweeps: int) -> int:
    """Operations for one agent's step."""
    d = n + 1
    return 2 * (d * h + h * h + h * d) + 2 * h + amp_flops(n, sweeps) + 30


def nbytes(n: int, h: int, agents: int, steps: int) -> int:
    """Bytes for one rollout of ``agents`` over ``steps``."""
    d = n + 1
    return (4 * (agents * ((d + 1) * h + (h + 1) * h + (h + 1) * d + d)
                 + steps * agents * (d + n + n - 1)
                 + steps * agents * (2 * d + 1)
                 + 2 * agents * (n + 2) + n * n) + 2 * steps * agents)
