"""Device meshes and sharded batch execution (counterpart of
code_robchar_tpu/parallel/mesh.py).

The batch axes of the system are embarrassingly parallel: controllers for
the MC engine, restarts or streams for the optimizers, agents for PPO.
The JAX package splits such an axis over a 1-D device mesh with
``jax.shard_map``: one controlling process runs the same single-device
program on each device's block.  The port keeps that single-controller
shape without ``torch.distributed``:

- a ``Mesh`` is an ordered list of ``torch.device`` entries along the
  ``BATCH_AXIS``; ``make_mesh(n)`` takes the first n CUDA devices, and a
  mesh built from an explicit list may repeat a device (as the CPU tests
  and the one-card smoke run do, in place of XLA's virtual host devices);
- a sharded call splits the batch axis into equal blocks, runs the port's
  own single-device function on each block on that block's device, and
  concatenates the outputs on the mesh's first device.  The blocks are
  driven one after another from the host; CUDA launches are asynchronous,
  so work on distinct cards overlaps wherever a block's function does not
  wait on its card.

Deviation: the JAX package returns arrays that stay sharded over the
mesh; the port returns one gathered tensor.  Every block runs the
single-device function at its own batch size, so each block picks its own
kernel route (ops/cuda_jacobi.amp_route / grad_route).

Determinism as in the JAX package: the MC sweep folds global lattice ids,
so a sharded sweep equals the unsharded one bit for bit; a sharded zoo
batch is deterministic given (mesh, inputs) and bit-equal to the
unsharded batch on a one-entry mesh, but re-blocking moves restarts
across kernel routes and lane groups, so on more entries the results are
equivalent, not equal (build_sharded_batch_fn).
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Optional

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.mc import engine

BATCH_AXIS = "batch"


class Mesh:
    """A 1-D mesh: the ordered devices along ``BATCH_AXIS``.
    ``devices`` is an object array of ``torch.device`` (``devices.size``
    is the mesh size, as on a ``jax.sharding.Mesh``); entries may
    repeat."""

    axis_names = (BATCH_AXIS,)

    def __init__(self, devices):
        devs = [config.resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them when
    None).  Raises when CUDA is unavailable or has fewer devices; a mesh
    that repeats a device is built with ``Mesh([...])``."""
    config.resolve_device("cuda")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}): {count} CUDA devices")
    return Mesh([f"cuda:{i}" for i in range(n)])


def on(device: torch.device):
    """The context that makes ``device`` current for launches through the
    kernels' C entries (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _index(device: torch.device) -> int:
    if device.index is not None:
        return device.index
    return torch.cuda.current_device() if device.type == "cuda" else 0


def same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and _index(a) == _index(b)


def on_device(obj, device):
    """``obj`` itself when it lives on ``device``; else a shallow copy
    whose tensor attributes on ``obj.device`` are moved to ``device``
    (how a block of an optimizer or a trainer runs on another card)."""
    device = torch.device(device)
    if same_device(obj.device, device):
        return obj
    view = copy.copy(obj)
    for name, val in vars(obj).items():
        if isinstance(val, torch.Tensor) and same_device(val.device,
                                                         obj.device):
            setattr(view, name, val.to(device))
    view.device = device
    return view


def _tree_map(fn, *trees):
    """Apply ``fn`` to the tensor leaves of parallel trees (named tuples,
    tuples, lists and dicts); other leaves (None, numbers) come from the
    first tree."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *parts) for parts in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(tr[k] for tr in trees)) for k in t}
    return t


def check_divisible(mesh: Mesh, k: int, what: str = "batch") -> int:
    n_dev = mesh.devices.size
    if k % n_dev:
        raise ValueError(f"{what} count {k} must be a multiple of the "
                         f"mesh size {n_dev}")
    return n_dev


def shard_batch(mesh: Mesh, x, axis: int = 0) -> List[torch.Tensor]:
    """``x`` split along ``axis`` into one equal block per mesh entry, each
    block on its entry's device."""
    x = torch.as_tensor(x)
    n_dev = check_divisible(mesh, x.shape[axis])
    size = x.shape[axis] // n_dev
    return [blk.to(dev) for blk, dev in
            zip(torch.split(x, size, dim=axis), mesh.devices)]


def gather(mesh: Mesh, blocks, axis: int = 0) -> torch.Tensor:
    """The blocks of a sharded tensor concatenated along ``axis`` on the
    mesh's first device."""
    dev = mesh.devices[0]
    return torch.cat([b.to(dev) for b in blocks], dim=axis)


def shard_leading_tree(mesh: Mesh, tree, batch_size: int) -> list:
    """One tree per mesh entry: every tensor leaf whose leading dimension
    is ``batch_size`` split along it, the other leaves copied, all on the
    entry's device.  This is how a whole state (PPO's AgentState) is laid
    out for the sharded epoch."""
    n_dev = check_divisible(mesh, batch_size)
    size = batch_size // n_dev

    def block(j):
        dev = mesh.devices[j]

        def put(x):
            if x.ndim >= 1 and x.shape[0] == batch_size:
                x = x[j * size:(j + 1) * size]
            return x.to(dev)
        return _tree_map(put, tree)
    return [block(j) for j in range(n_dev)]


def gather_tree(mesh: Mesh, trees):
    """Per-entry output trees concatenated leaf by leaf along the leading
    axis on the mesh's first device (every tensor leaf of a sharded output
    carries the batch axis first)."""
    dev = mesh.devices[0]
    return _tree_map(lambda *leaves: torch.cat([x.to(dev) for x in leaves]),
                     *trees)


def _local_chunk(chunk, device, elements: int) -> int:
    if chunk is None:
        chunk = (engine.KERNEL_CHUNK if device.type == "cuda"
                 else engine.DEFAULT_CHUNK)
    return min(chunk, elements)


def _sharded_engine(sweep, mesh, controllers, noises, bootreps, chunk,
                    **kw):
    ctrl = torch.as_tensor(controllers)
    c_global = ctrl.shape[0]
    n_dev = check_divisible(mesh, c_global, "controller")
    c_local = c_global // n_dev
    num_l = len(noises)
    outs = []
    for j, (dev, blk) in enumerate(zip(mesh.devices,
                                       shard_batch(mesh, ctrl))):
        with on(dev):
            outs.append(sweep(
                controllers=blk, noises=noises, bootreps=bootreps,
                chunk=_local_chunk(chunk, dev, num_l * c_local * bootreps),
                device=dev, c_offset=j * c_local, c_global=c_global, **kw))
    return outs


def sharded_mc_sweep(mesh: Mesh, h0, controllers, noises, key, bootreps: int,
                     in_spin: int, out_spin: int, *,
                     complex_offdiag: bool = True, use_jacobi: bool = True,
                     chunk=None) -> torch.Tensor:
    """(L, C, B) fidelity tensor with the controller axis split over the
    mesh.  Each block sweeps with keys folded from the global lattice
    ids (engine.mc_fidelity_sweep's ``c_offset`` / ``c_global``), so the
    result equals the unsharded sweep bit for bit.  A block's chunk is
    ``min(chunk, L * C_local * B)``."""
    outs = _sharded_engine(engine.mc_fidelity_sweep, mesh, controllers,
                           noises, bootreps, chunk, h0=h0, key=key,
                           in_spin=in_spin, out_spin=out_spin,
                           complex_offdiag=complex_offdiag,
                           use_jacobi=use_jacobi)
    return gather(mesh, outs, axis=1)


def sharded_mc_metrics(mesh: Mesh, h0, controllers, noises, key,
                       bootreps: int, in_spin: int, out_spin: int, *,
                       complex_offdiag: bool = True, use_jacobi: bool = True,
                       chunk=None, alpha: float = 0.05):
    """The fused sweep and metric reduction (engine.mc_metric_sweep) with
    the controller axis split over the mesh: the 15 (L, C) metric tensors,
    equal to the unsharded run's; the (L, C, B) fidelity tensor is never
    held.  A block's chunk is ``min(chunk, L * C_local * B)`` elements, so
    its chunks hold whole cells as the unsharded run's do."""
    outs = _sharded_engine(engine.mc_metric_sweep, mesh, controllers,
                           noises, bootreps, chunk, h0=h0, key=key,
                           in_spin=in_spin, out_spin=out_spin,
                           complex_offdiag=complex_offdiag,
                           use_jacobi=use_jacobi, alpha=alpha)
    return {k: gather(mesh, [o[k] for o in outs], axis=1) for k in outs[0]}


def build_sharded_batch_fn(mesh: Mesh, opt):
    """``fn(x0s, keys) -> BatchResult``: ``opt._run_batch`` with the
    restart axis split over the mesh.  Each block runs the optimizer's own
    batch on its entry's device (``on_device``), reading the optimizer's
    noise and ensembles at call time; ``opt.stats`` becomes the sum of the
    blocks' stats.

    Determinism: a sharded run is deterministic given (mesh, inputs), and
    on a one-entry mesh it is the unsharded batch bit for bit.  On more
    entries it is not bitwise the unsharded batch: a block of K / n
    restarts takes its own kernel route and lane grouping, and the L-BFGS
    lanes recycle restarts within their block, so rounding moves a few
    restarts by some ulps, which the optimizers' accept / reject
    boundaries amplify.  Each restart remains a trajectory of the same
    optimizer; the results are statistically equivalent."""
    def run(x0s, keys):
        xb, kb = shard_batch(mesh, x0s), shard_batch(mesh, keys)
        outs, stats = [], {}
        for dev, x, k in zip(mesh.devices, xb, kb):
            view = on_device(opt, dev)
            with on(dev):
                outs.append(view._run_batch(x, k))
            for name, val in view.stats.items():
                stats[name] = stats.get(name, 0) + val
        opt.stats = stats
        return gather_tree(mesh, outs)
    return run


def sharded_run_batch(mesh: Mesh, opt, x0s, keys):
    """An optimizer-zoo restart batch sharded over the mesh.

    Stateless-batch optimizers (L-BFGS, NM, SNOB) run through
    ``build_sharded_batch_fn``.  Adam's persistent streams carry their
    state on the instance: for it this sets the instance's ``mesh``, resets
    its streams (a stream from an earlier unsharded run would otherwise
    advance and ``x0s`` be ignored) and advances one segment with the
    stream axis sharded; the instance keeps the mesh afterwards."""
    x0s = torch.as_tensor(x0s, dtype=opt.dtype)
    check_divisible(mesh, x0s.shape[0], "restart")
    if opt.persistent_streams:
        opt.mesh = mesh
        opt._stream = None
        opt._table = None
        return opt._run_batch(x0s.to(opt.device), keys)
    saved, opt.mesh = opt.mesh, mesh
    try:
        return opt._run_batch_sharded(x0s, keys)
    finally:
        opt.mesh = saved
