"""The Monte-Carlo robustness sweep (counterpart of
code_robchar_tpu/mc/engine.py).

For every lattice element — noise level l x controller c x bootstrap rep
b, flattened as ``gid = (l*C + c)*B + b`` — the sweep draws a structured
perturbation from ``fold_in(key, gid)`` (split into the diagonal,
real-coupling and imaginary-coupling keys, as the JAX engine does),
assembles the perturbed, biased Hamiltonian in the lanes layout
(ops/mc_draws.draw_lanes: one CUDA kernel launch a chunk for CUDA
tensors, ops/prng and ops/noise.assemble_lanes for CPU ones) and scores
its transfer fidelity
(ops/cuda_jacobi.fidelity_herm: the CUDA kernel for CUDA tensors, the
plain version for CPU ones; ``use_jacobi=False`` takes instead the JAX
package's LAPACK parity path, a complex ``torch.linalg.eigh`` of the same
draws through ops/propagate.py, on the same device):

    fid[l, c, b] = |<out| exp(-i T_c (H0 + Z(key_lcb, sigma_l)
                    + diag(x_c))) |in>|^2

The lattice runs as a Python loop over chunks of about ``chunk`` elements.
``mc_metric_sweep`` takes whole (noise, controller) cells per chunk —
the bootstrap axis is fastest — and reduces each chunk at once to the
five-metric x three-band tensors (``metric_tensors``), so the (L, C, B)
fidelity tensor is never held.  Same keys, so the same draws as the
unfused ``mc_fidelity_sweep``.  A block of the controller axis
(``c_offset``, ``c_global``; the sharded sweeps of parallel/mesh.py)
folds the global ids, so it draws what the whole sweep draws there.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.metrics.rim import (compute_dkw_error,
                                                wd_from_ideal_zero)
from code_robchar_tpu_torch.metrics.stats import metric_registry
from code_robchar_tpu_torch.ops import (cuda_jacobi, mc_draws, noise, prng,
                                       propagate)
from code_robchar_tpu_torch.utils import trace

#: elements per chunk on the CPU (keeps an x64 chunk's working set small)
DEFAULT_CHUNK = 8192
#: elements per chunk on CUDA: one kernel launch per chunk
KERNEL_CHUNK = 131072

RIM_NAME = r"$W(.,\delta(x-1))$"


def _setup(h0, controllers, noises, key, device, chunk):
    """Inputs as tensors on the resolved device, in h0's real dtype."""
    device = config.resolve_device(device)
    h0 = torch.as_tensor(h0, device=device)
    h0r = (h0.real if h0.is_complex() else h0).contiguous()
    ctrl = torch.as_tensor(controllers, device=device).to(h0r.dtype) \
        .contiguous()
    noises = torch.as_tensor(noises, device=device).to(h0r.dtype) \
        .contiguous()
    if chunk is None:
        chunk = KERNEL_CHUNK if device.type == "cuda" else DEFAULT_CHUNK
    return h0r, ctrl, noises, key.to(device).contiguous(), chunk


def _fids(h0r, ctrl, noises, key, start, count, bootreps, in_spin,
          out_spin, complex_offdiag, use_jacobi, c_offset=0, c_global=None):
    """Fidelities of the lattice elements with local flat ids start ..
    start + count - 1 (layout (L, C_local, B) over the controller block
    ``ctrl``).  Each element's key folds its global id in the (L,
    ``c_global``, B) lattice, the block starting at controller
    ``c_offset``, so a block of a sharded sweep draws what the unsharded
    sweep draws for those elements (ops/mc_draws.py)."""
    c_global = ctrl.shape[0] if c_global is None else c_global
    with trace.span("mc.draws"):
        if use_jacobi:
            # one kernel launch on the card, its plain version on the CPU
            ar, ai, t = mc_draws.draw_lanes(h0r, ctrl, noises, key, start,
                                            count, bootreps, complex_offdiag,
                                            c_offset, c_global)
        else:
            # the element kernel of the JAX package's LAPACK path: the
            # complex perturbation of the same keys, then a complex eigh
            keys, xs, scales = mc_draws.lattice_keys(
                ctrl, noises, key, start, count, bootreps, c_offset,
                c_global)
            h0c = h0r.to(config.complex_dtype(h0r.dtype))
            z = noise.structured_perturbation(keys, h0r.shape[-1], scales,
                                              complex_offdiag,
                                              dtype=h0c.dtype)
    with trace.span("mc.kernel"):
        if not use_jacobi:
            return propagate.fidelity_from_controller(h0c + z, xs, in_spin,
                                                      out_spin)
        return cuda_jacobi.fidelity_herm(ar, ai, t, in_spin, out_spin)


@trace.spanned("mc.sweep")
def mc_fidelity_sweep(h0, controllers, noises, key: torch.Tensor,
                      bootreps: int, in_spin: int, out_spin: int,
                      complex_offdiag: bool = True,
                      chunk: Optional[int] = None,
                      device=None, use_jacobi: bool = True,
                      c_offset: int = 0,
                      c_global: Optional[int] = None) -> torch.Tensor:
    """Fidelity-distribution tensor of shape (L, C, B).

    h0: (n, n) drift Hamiltonian (its real part is used); controllers:
    (C, n+1); noises: (L,); key: a prng key.  numpy or torch inputs;
    ``device=None`` resolves as config.resolve_device.  The sweep at noise
    level l uses sigma = noises[l] for every draw (mcsim.py:425).
    ``use_jacobi=True`` scores each chunk with the Jacobi fidelity (the
    kernel on the card, its plain version on the CPU); ``False`` with a
    complex eigh of the same draws (ops/propagate.py).  Neither route falls
    back to the other.  ``controllers`` may be the block of a larger
    (``c_global``) controller set starting at ``c_offset`` (the sharded
    sweep's blocks, parallel/mesh.py): its draws are the whole set's."""
    h0r, ctrl, noises, key, chunk = _setup(h0, controllers, noises, key,
                                           device, chunk)
    num_l, num_c = noises.shape[0], ctrl.shape[0]
    total = num_l * num_c * bootreps
    out = torch.empty(total, dtype=h0r.dtype, device=h0r.device)
    for start in range(0, total, chunk):
        with trace.span("mc.chunk"):
            count = min(chunk, total - start)
            out[start:start + count] = _fids(
                h0r, ctrl, noises, key, start, count, bootreps, in_spin,
                out_spin, complex_offdiag, use_jacobi, c_offset, c_global)
    return out.reshape(num_l, num_c, bootreps)


@trace.spanned("mc.sweep")
def mc_metric_sweep(h0, controllers, noises, key: torch.Tensor,
                    bootreps: int, in_spin: int, out_spin: int,
                    complex_offdiag: bool = True,
                    chunk: Optional[int] = None,
                    alpha: float = 0.05,
                    device=None,
                    use_jacobi: bool = True,
                    c_offset: int = 0,
                    c_global: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Metric tensors (5 metrics x 3 DKW bands, each (L, C)) with the
    reduction fused into the sweep: the same draws as
    ``metric_tensors(mc_fidelity_sweep(...), alpha)``, without holding the
    (L, C, B) fidelity tensor.  Each chunk holds whole cells, about
    ``chunk`` elements.  ``use_jacobi``, ``c_offset`` and ``c_global`` as
    in ``mc_fidelity_sweep``."""
    h0r, ctrl, noises, key, chunk = _setup(h0, controllers, noises, key,
                                           device, chunk)
    num_l, num_c = noises.shape[0], ctrl.shape[0]
    cells = num_l * num_c
    step = max(1, min(chunk // bootreps, cells)) * bootreps
    total = cells * bootreps
    parts = []
    for start in range(0, total, step):
        with trace.span("mc.chunk"):
            fids = _fids(h0r, ctrl, noises, key, start,
                         min(step, total - start), bootreps, in_spin,
                         out_spin, complex_offdiag, use_jacobi, c_offset,
                         c_global)
            with trace.span("mc.reduce"):
                parts.append(metric_tensors(fids.reshape(-1, bootreps),
                                            alpha))
    with trace.span("mc.gather"):
        return {k: torch.cat([p[k] for p in parts]).reshape(num_l, num_c)
                for k in parts[0]}


def _rim_sortless(fids: torch.Tensor) -> torch.Tensor:
    # W1(F, delta_1) = E[1 - F] for F in [0, 1]: no sort needed
    return torch.mean(1.0 - fids, dim=-1)


def metric_tensors(fids, alpha: float = 0.05) -> Dict[str, torch.Tensor]:
    """All five metrics x {center, upper, lower} over the trailing axis.

    Key names follow the .mcm schema (mcsim.py:487-498), including the
    reference's band-naming inversion: "upper" is computed from
    fids - dkw and "lower" from fids + dkw, because the ideal sits at
    fidelity 1 (mcsim.py:483-485).  The RIM uses the sortless identity
    W1(F, delta(x-1)) = mean(1 - F)."""
    fids = torch.as_tensor(fids)
    eps = compute_dkw_error(alpha, fids.shape[-1])
    shifted_lower = torch.clamp(fids + eps, 0.0, 1.0)
    shifted_upper = torch.clamp(fids - eps, 0.0, 1.0)
    registry = dict(metric_registry)
    registry[RIM_NAME] = _rim_sortless
    out = {}
    for name, fn in registry.items():
        out[name] = fn(fids)
        out[name + " upper"] = fn(shifted_upper)
        out[name + " lower"] = fn(shifted_lower)
    return out


def characterise(h0, controllers, noises, key: torch.Tensor, bootreps: int,
                 in_spin: int, out_spin: int, *, alpha: float = 0.05,
                 complex_offdiag: bool = True, chunk: Optional[int] = None,
                 return_fids: bool = True,
                 device=None,
                 use_jacobi: bool = True,
                 mesh=None) -> Dict[str, torch.Tensor]:
    """One-call robustness characterisation: the five-metric x three-band
    tensor dict, plus the (L, C, B) ``fids`` when ``return_fids``.
    ``return_fids=False`` takes the fused sweep (mc_metric_sweep): the same
    metric values without holding the fidelity tensor.  ``use_jacobi`` as
    in ``mc_fidelity_sweep``.  With a ``mesh`` (parallel/mesh.py) the
    controller axis is split over its entries (``device`` is then the
    mesh's), with the same draws and values as the unsharded sweep."""
    kwargs = dict(complex_offdiag=complex_offdiag, chunk=chunk,
                  use_jacobi=use_jacobi)
    if mesh is not None:
        from code_robchar_tpu_torch.parallel import mesh as pmesh
        sweep = functools.partial(pmesh.sharded_mc_sweep, mesh)
        metrics = functools.partial(pmesh.sharded_mc_metrics, mesh)
    else:
        sweep, metrics = mc_fidelity_sweep, mc_metric_sweep
        kwargs["device"] = device
    if not return_fids:
        return metrics(h0, controllers, noises, key, bootreps, in_spin,
                       out_spin, alpha=alpha, **kwargs)
    fids = sweep(h0, controllers, noises, key, bootreps, in_spin, out_spin,
                 **kwargs)
    out = metric_tensors(fids, alpha)
    out["fids"] = fids
    return out


def arim_from_rims(rims) -> torch.Tensor:
    """Algorithm-level RIM: W1 of the trailing-axis RIM sample (over
    controllers) from delta(x-0) (generate_arim_all_fig5.py:119,166)."""
    return wd_from_ideal_zero(torch.clamp(torch.as_tensor(rims), 0.0, 1.0))


def bootstrap_statistic_std(key: torch.Tensor, sample: torch.Tensor,
                            statistic, bootsamples: int = 100
                            ) -> torch.Tensor:
    """Nonparametric bootstrap std (population) of a trailing-axis
    statistic (mcsim.py:267-275 ``bootstrap_resampling_std``): the
    resampling indices are ``prng.randint(key, (bootsamples, n), 0, n)``,
    int64 for a float64 sample (the JAX package's x64 regime) and int32
    otherwise, so the same key resamples as the JAX package does; all
    ``bootsamples`` resamples are evaluated in one call of ``statistic``
    over a (..., bootsamples, n) tensor."""
    sample = torch.as_tensor(sample)
    n = sample.shape[-1]
    dtype = torch.int64 if sample.dtype == torch.float64 else torch.int32
    idx = prng.randint(key.to(sample.device), (bootsamples, n), 0, n, dtype)
    stats = statistic(sample[..., idx.long()])
    return torch.std(stats, dim=-1, correction=0)
