"""The multi-device dry run (counterpart of
``__graft_entry__.dryrun_multichip``): every mesh path once at tiny
shapes on an n-entry mesh.

    python3 -m code_robchar_tpu_torch.parallel.dryrun [n] [device]

The mesh takes the first n CUDA devices when there are that many, else it
repeats ``device`` (None: the card) n times, as the JAX package's dry run
falls back to n virtual CPU devices.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                  sharded_mc_metrics,
                                                  sharded_mc_sweep,
                                                  sharded_run_batch)


def dryrun_multichip(n_devices: int, device=None) -> Mesh:
    """Run a sharded PPO training run, an Adam stream run, the MC sweep and
    its fused metrics, and the zoo's restarts (through ``run()`` and
    ``sharded_run_batch``) on an ``n_devices``-entry mesh; raises on any
    failure and returns the mesh."""
    from code_robchar_tpu_torch.models import LBFGS, Adam, PPO_en
    from code_robchar_tpu_torch.ops import chain, prng

    device = config.resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = make_mesh(n_devices)
    else:
        mesh = Mesh([device] * n_devices)
    n = n_devices
    run_kw = dict(testing=True, fid_threshold=0.0,
                  run_until_told_to_stop=True, landscape_exploration=True,
                  save_topc=4, mesh=mesh, device=device)

    # a PPO training run with the agent axis sharded
    ppo = PPO_en(4, 0, 2, run_until_completion_its=8 * n, num_agents=n,
                 **run_kw)
    best = ppo.run(epochs=1, steps_per_epoch=8, train_pi_iters=2,
                   train_v_iters=2)
    assert 0.0 <= best <= 1.0 + 1e-6
    assert ppo.record["func_calls"] is not None

    # an Adam stream run, the streams sharded
    adam = Adam(4, 0, 2, run_until_completion_its=8 * n,
                restart_batch=2 * n, segment_its=8, **run_kw)
    assert adam.run() is not None and adam.record["func_calls"] is not None

    # the MC sweep and its fused metrics, the controllers sharded
    h0 = chain.xx_hamiltonian_real(4, device=device)
    ctrl = np.random.default_rng(0).uniform(-5, 5, (2 * n, 5)).astype(
        np.float32)
    fids = sharded_mc_sweep(mesh, h0, ctrl, [0.0, 0.05], prng.key(1), 3, 0,
                            2, chunk=64)
    assert fids.shape == (2, 2 * n, 3) and bool(torch.isfinite(fids).all())
    md = sharded_mc_metrics(mesh, h0, ctrl, [0.0, 0.05], prng.key(1), 3, 0,
                            2, chunk=64)
    assert md[engine.RIM_NAME].shape == (2, 2 * n)

    # the zoo's restarts: the public run() and sharded_run_batch
    zopt = LBFGS(4, 0, 2, repeats=2 * n, run_until_completion_its=10**9,
                 restart_batch=2 * n, **run_kw)
    assert zopt.run() is not None and len(zopt.record["controllers"]) >= 1
    zopt2 = LBFGS(4, 0, 2, testing=True, fid_threshold=2.0, repeats=2 * n,
                  run_until_told_to_stop=True,
                  run_until_completion_its=10**9,
                  landscape_exploration=True, save_topc=4, device=device)
    zres = sharded_run_batch(mesh, zopt2, zopt2.init_points(2 * n),
                             prng.split(prng.key(2), 2 * n))
    assert zres.x.shape == (2 * n, 5)
    print(f"dryrun_multichip({n}) on {mesh}: sharded PPO run + Adam stream "
          f"+ MC sweep + fused metrics + zoo restarts (run() and "
          f"sharded_run_batch) OK")
    return mesh


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else None)
