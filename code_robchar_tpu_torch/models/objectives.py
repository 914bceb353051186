"""Objective builders shared by the optimizer zoo (counterpart of
code_robchar_tpu/models/objectives.py).

The reference builds per-optimizer ``infidelity`` closures over four noise
regimes (qnewton.py:383-455, 500-514).  The JAX package has two forms of
each, and so has the port:

- the single-point builders ``make_infidelity``, ``make_exact_gradient``,
  ``make_fd_gradient`` and ``make_wass_cost``: a function of one
  controller ``x (d,)`` and its own key, here broadcast over a leading
  batch, ``f(xs (K, d), keys (K, 2))`` being what ``jax.vmap(f)`` gives
  for the same keys; a whole batch is one kernel launch;
- the batch builders ``make_*_batch``: ``(xs (K, d), key) -> (infids (K,),
  fcalls (K,))`` with one key for the batch, folded with the lane index.
  Their draws differ from those of the single-point form.

Each regime, with the same draws as the JAX package for the same key:

- noiseless:        1 - |<out|U|in>|^2, and the exact gradient
                    (``make_exact_gradient_batch``, the gradient kernel);
- ham_noisy:        a fresh real-offdiagonal structured perturbation per
                    controller, its key folded from the lane index
                    (``_structured_draws_lanes``);
- use_fixed_ham:    the mean fidelity over a pre-drawn ensemble;
- fid_noisy:        binomial shot noise on each controller's fidelity (on
                    the ensemble's mean under use_fixed_ham), its key
                    folded from the lane index, optionally the adaptive
                    Bayesian protocol (ops/noise.py), which bills its
                    shots in-band.

Every fidelity goes through ops/cuda_jacobi: the CUDA kernels for CUDA
tensors, their plain versions for CPU ones (the round-robin pivot order of
the kernels; the JAX package's single-point functions take the cyclic
order, which agrees to ~1e-15 at float64).  Keys are prng keys; they may
lie on the CPU while the batch lies on the card, and the draws are made on
the batch's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from code_robchar_tpu_torch.metrics.rim import wd_from_ideal
from code_robchar_tpu_torch.ops import cuda_jacobi, noise as noise_ops, prng


class ObjectiveSpec(NamedTuple):
    h0: torch.Tensor                # (n, n) real drift
    in_spin: int
    out_spin: int
    noise: float                    # sigma for ham noise
    fid_noisy: bool
    ham_noisy: bool
    draws: int
    adaptive: bool
    adp_tol: float
    fixed_hams: Optional[torch.Tensor]  # (R, n, n) pre-perturbed ensemble
    mul_fac: int                    # fcall multiplier (train_size or 1)


def _real(h: torch.Tensor) -> torch.Tensor:
    return (h.real if h.is_complex() else h).contiguous()


def _lanes(h: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(n, n, K) lanes Hamiltonians h + diag(x[:n]) for the drifts h
    (K, n, n) (or one (n, n) for all) of the controllers xs (K, n+1); the
    controls are added after the drift, as the single-point reference
    forms ``h + eye * x`` (realform.py:319-326)."""
    n = h.shape[-1]
    k = xs.shape[0]
    a = h.expand(k, n, n).permute(1, 2, 0).contiguous()
    i = torch.arange(n, device=a.device)
    a[i, i] = a[i, i] + xs[:, :n].T.to(a.dtype)
    return a


def _point_draws(keys: torch.Tensor, n: int, noise: float,
                 dt: torch.dtype) -> torch.Tensor:
    """The real-offdiagonal structured perturbation zr (K, n, n) of each
    key (K, 2) (qnewton.py:366-379): one key a point, as the single-point
    reference draws it."""
    zr, _ = noise_ops.structured_perturbation_parts(
        keys, n, noise, complex_offdiag=False, dtype=dt)
    return zr


def make_infidelity(spec: ObjectiveSpec):
    """(xs (..., d), keys (..., 2)) -> (infids (...), fcalls (...) int32):
    the single-point objective of every regime, each point with its own
    key, as ``jax.vmap`` of the JAX package's ``make_infidelity`` (:45).

    Each key splits into ``kh, ks``: the ham noise from ``kh`` (one draw a
    point), the shot noise from ``ks``; the adaptive protocol bills
    ``extra + draws`` calls a point, every other regime 1.  Under the
    fixed ensemble the fidelity is the mean over its members, the shot
    noise is drawn from the unsplit key, and the call count is 1 (the
    optimizers apply ``train_size``).  One amplitude-kernel launch a call
    (K x R matrices under the fixed ensemble)."""
    n = spec.h0.shape[-1]
    h0r = _real(spec.h0)
    fixed = _real(spec.fixed_hams) if spec.fixed_hams is not None else None

    def infid(xs, keys):
        lead = xs.shape[:-1]
        xs = xs.reshape(-1, n + 1)
        keys = keys.reshape(-1, 2).to(xs.device)
        calls = torch.ones(xs.shape[0], dtype=torch.int32, device=xs.device)
        if fixed is not None:
            fids = ensemble_fidelities(fixed, xs, spec.in_spin, spec.out_spin)
            fid = fids.sum(1) / fids.shape[1]
            if spec.fid_noisy:
                fid = noise_ops.shot_noise_fidelity(keys, fid, spec.draws)
            return (1.0 - fid).reshape(lead), calls.reshape(lead)
        kh = ks = None
        if spec.ham_noisy or spec.fid_noisy:
            kh, ks = prng.split(keys).unbind(-2)
        h = h0r
        if spec.ham_noisy:
            h = h0r + _point_draws(kh, n, spec.noise, h0r.dtype)
        fid = cuda_jacobi.fidelity_sym(_lanes(h, xs),
                                       xs[:, n].abs().to(h0r.dtype),
                                       spec.in_spin, spec.out_spin)
        if spec.fid_noisy:
            if spec.adaptive:
                fid, extra = noise_ops.adaptive_shot_fidelity(
                    ks, fid, spec.draws, spec.adp_tol)
                calls = (extra + spec.draws).to(torch.int32)
            else:
                fid = noise_ops.shot_noise_fidelity(ks, fid, spec.draws)
        return (1.0 - fid).reshape(lead), calls.reshape(lead)

    return infid


def make_exact_gradient(spec: ObjectiveSpec):
    """(xs (..., d)) -> (infids (...), grads (..., d)): the exact analytic
    gradient of the noiseless objective (JAX :100), one launch of the
    gradient kernel for the batch."""
    grad_b = make_exact_gradient_batch(spec)
    n = spec.h0.shape[-1]

    def f(xs):
        lead = xs.shape[:-1]
        err, grad = grad_b(xs.reshape(-1, n + 1))
        return err.reshape(lead), grad.reshape(lead + (n + 1,))
    return f


#: the forward-difference step where the dtype resolves the JAX package's
#: 1e-8 (float64); below float64 it is sqrt of the dtype's machine epsilon
#: (3.45e-4 at float32), the rule that gives scipy's 1.49e-8 at float64.
#: At float32, x + 1e-8 rounds to x for |x| > 0.17, so the JAX package's
#: step gives a zero difference on nearly every coordinate of the
#: controller box and L-BFGS stops at its starts.
FD_EPS_F64 = 1e-8


def fd_eps(dtype: torch.dtype, eps: Optional[float] = None) -> float:
    """The forward-difference step for ``dtype``: ``eps`` when given."""
    if eps is not None:
        return eps
    if dtype == torch.float64:
        return FD_EPS_F64
    return float(torch.finfo(dtype).eps) ** 0.5


def make_fd_gradient(infid_fn, dim: int, eps: Optional[float] = None):
    """Forward-difference gradient of a single-point objective (JAX :243):
    (xs (..., d), keys (..., 2)) -> (f0 (...), g (..., d), fcalls (...)).
    Each key splits into ``dim + 1``: the first for f0, the others for the
    probes x + eps e_i (``fd_eps``: the JAX package's 1e-8 at float64);
    one gradient bills the calls of its dim + 1 evaluations
    (qnewton.py:513-514), which go to ``infid_fn`` as one batch."""
    def grad(xs, keys):
        eps_ = fd_eps(xs.dtype, eps)
        lead = xs.shape[:-1]
        eye = torch.eye(dim, dtype=xs.dtype, device=xs.device)
        pts = torch.cat([xs[..., None, :], xs[..., None, :] + eps_ * eye],
                        dim=-2)                          # (..., d+1, d)
        fs, cs = infid_fn(pts, prng.split(keys, dim + 1))
        f0 = fs[..., 0]
        g = (fs[..., 1:] - f0[..., None]) / eps_
        return f0, g.reshape(lead + (dim,)), cs.sum(-1).to(torch.int32)
    return grad


#: the most Hamiltonians ``make_wass_cost`` puts in one launch (a chunk of
#: controllers times the reps): the draws' int64 words of 2^21 matrices
#: take ~0.5 GB a temporary
WASS_LANES = 1 << 21


def make_wass_cost(spec: ObjectiveSpec, bootstrap_reps: int = 5):
    """(xs (..., d), keys (..., 2)) -> costs (...): the Wasserstein
    robustness cost (qnewton.py:447-455; JAX :280), RIM_1 of
    ``bootstrap_reps`` ham-noisy fidelities around each controller, clipped
    to [0, 1].  Each key splits into ``bootstrap_reps``, one real
    structured draw each.  The controllers go through the amplitude kernel
    in chunks of at most ``WASS_LANES`` Hamiltonians; the keys are per
    controller, so a chunk draws what the whole batch would."""
    n = spec.h0.shape[-1]
    h0r = _real(spec.h0)
    reps = bootstrap_reps
    chunk = max(1, WASS_LANES // reps)

    def cost_chunk(xs, keys):
        k = xs.shape[0]
        zr = _point_draws(prng.split(keys, reps).reshape(k * reps, 2), n,
                          spec.noise, h0r.dtype)
        xr = xs.repeat_interleave(reps, dim=0)              # (K*R, d)
        fids = cuda_jacobi.fidelity_sym(_lanes(h0r + zr, xr),
                                        xr[:, n].abs().to(h0r.dtype),
                                        spec.in_spin, spec.out_spin)
        return wd_from_ideal(fids.clamp(0.0, 1.0).reshape(k, reps))

    def cost(xs, keys):
        lead = xs.shape[:-1]
        xs = xs.reshape(-1, n + 1)
        keys = keys.reshape(-1, 2).to(xs.device)
        out = [cost_chunk(xs[i:i + chunk], keys[i:i + chunk])
               for i in range(0, xs.shape[0], chunk)]
        return torch.cat(out).reshape(lead)
    return cost


def make_exact_gradient_batch(spec: ObjectiveSpec):
    """(xs (K, d)) -> (errs (K,), grads (K, d)): the exact analytic
    gradient of the noiseless objective, one launch of the gradient kernel
    for the whole batch."""
    h0r = _real(spec.h0)

    def f(xs):
        return cuda_jacobi.infidelity_and_gradient_sym(
            h0r, xs.contiguous(), spec.in_spin, spec.out_spin)
    return f


def _make_fid_lanes(n: int, in_spin: int, out_spin: int):
    """(a (n, n, B), t (B,)) -> fids (B,): the shared lanes fidelity, one
    launch of the amplitude kernel."""
    def fid_lanes(a, t):
        return cuda_jacobi.fidelity_sym(a, t, in_spin, out_spin)
    return fid_lanes


def _assemble_lanes(h0r, xs, zdiag=None, znn=None):
    """(n, n, K) lanes Hamiltonians: drift + per-lane diagonal controls
    (+ optional pre-scaled structured-noise draws zdiag (K, n),
    znn (K, n-1))."""
    n = h0r.shape[-1]
    k = xs.shape[0]
    dt = h0r.dtype
    a = h0r[:, :, None].expand(n, n, k).clone()
    add_diag = xs[:, :n].T.to(dt)
    if zdiag is not None:
        add_diag = add_diag + zdiag.T
    i = torch.arange(n, device=h0r.device)
    a[i, i] = a[i, i] + add_diag
    if znn is not None:
        lo, hi = i[1:], i[:-1]
        a[lo, hi] = a[lo, hi] + znn.T
        a[hi, lo] = a[hi, lo] + znn.T
    return a


def fidelity_batch(h0r: torch.Tensor, xs: torch.Tensor, in_spin: int,
                   out_spin: int) -> torch.Tensor:
    """Noiseless fidelity of each controller of xs (K, n+1) under the
    drift h0r (n, n): (K,)."""
    n = h0r.shape[-1]
    return cuda_jacobi.fidelity_sym(_assemble_lanes(h0r, xs),
                                    xs[:, n].abs().to(h0r.dtype), in_spin,
                                    out_spin)


def ensemble_fidelities(hams: torch.Tensor, xs: torch.Tensor, in_spin: int,
                        out_spin: int) -> torch.Tensor:
    """Fidelity of each controller of xs (K, n+1) under each Hamiltonian of
    the ensemble hams (R, n, n): (K, R), one lanes batch of K * R."""
    n = hams.shape[-1]
    k, r = xs.shape[0], hams.shape[0]
    dt = hams.dtype
    a = hams.permute(1, 2, 0)[:, :, None, :].expand(n, n, k, r).clone()
    i = torch.arange(n, device=hams.device)
    a[i, i] = a[i, i] + xs[:, :n].T.to(dt)[:, :, None]
    t = xs[:, n].abs().to(dt).repeat_interleave(r)
    return cuda_jacobi.fidelity_sym(a.reshape(n, n, k * r), t, in_spin,
                                    out_spin).reshape(k, r)


def _structured_draws_lanes(key, count, n, noise, dt, device):
    """Per-lane real structured-noise draws (qnewton.py:366-379): one
    (zdiag (count, n), znn (count, n-1)) pair per lane, keys folded from
    the lane index with the reference's 3-way split and order (the third
    stream, the complex-offdiagonal part, is unused by the real variant).
    A width n-1 draw is the first n-1 entries of the width n draw under
    the same key, so one threefry pass gives both."""
    keys = prng.fold_in(key.to(device), torch.arange(count, device=device))
    z = prng.normal(prng.split(keys, 3)[:, :2], (n,), dt)
    return z[:, 0] * noise, z[:, 1, :n - 1] * noise


def make_infidelity_batch(spec: ObjectiveSpec):
    """(xs (K, d), key) -> (infids (K,), fcalls (K,)): the batched
    objective of every regime, with the JAX package's key use (``kh, ks =
    split(key)``; ham noise from kh and shot noise from ks, each folded
    with the lane index).  The adaptive protocol bills ``extra + draws``
    calls a controller, every other regime 1."""
    n = spec.h0.shape[-1]
    h0r = _real(spec.h0)
    fixed = _real(spec.fixed_hams) if spec.fixed_hams is not None else None
    fid_lanes = _make_fid_lanes(n, spec.in_spin, spec.out_spin)

    def lane_keys(ks, k, device):
        return prng.fold_in(ks.to(device), torch.arange(k, device=device))

    def infid(xs, key):
        k = xs.shape[0]
        calls = torch.ones(k, dtype=torch.int32, device=xs.device)
        # the noiseless regimes draw nothing: no split
        kh, ks = prng.split(key) if spec.ham_noisy or spec.fid_noisy \
            else (None, None)
        if fixed is not None:
            # mean FIDELITY over the pre-drawn ensemble (qnewton.py:425-444)
            fids = ensemble_fidelities(fixed, xs, spec.in_spin, spec.out_spin)
            fid = fids.sum(1) / fids.shape[1]
            if spec.fid_noisy:
                fid = noise_ops.shot_noise_fidelity(
                    lane_keys(ks, k, xs.device), fid, spec.draws)
            return 1.0 - fid, calls
        zdiag = znn = None
        if spec.ham_noisy:
            zdiag, znn = _structured_draws_lanes(kh, k, n, spec.noise,
                                                 h0r.dtype, xs.device)
        a = _assemble_lanes(h0r, xs, zdiag, znn)
        fid = fid_lanes(a, xs[:, n].abs().to(h0r.dtype))
        if spec.fid_noisy:
            keys = lane_keys(ks, k, xs.device)
            if spec.adaptive:
                fid, extra = noise_ops.adaptive_shot_fidelity(
                    keys, fid, spec.draws, spec.adp_tol)
                calls = (extra + spec.draws).to(torch.int32)
            else:
                fid = noise_ops.shot_noise_fidelity(keys, fid, spec.draws)
        return 1.0 - fid, calls

    return infid


def make_fd_gradient_batch(infid_batch_fn, dim: int,
                           eps: Optional[float] = None):
    """Batched forward-difference gradient: (xs (K, d), key) ->
    (f0 (K,), g (K, d), fcalls (K,)), the step from ``fd_eps``.  All
    K*(d+1) probes ride one lanes batch; one gradient costs d+1 objective
    calls (qnewton.py:513-514)."""
    def grad(xs, key):
        eps_ = fd_eps(xs.dtype, eps)
        k = xs.shape[0]
        eye = torch.eye(dim, dtype=xs.dtype, device=xs.device)
        probes = torch.cat([xs[:, None, :],
                            xs[:, None, :] + eps_ * eye[None]],
                           dim=1)                         # (K, d+1, d)
        fs, cs = infid_batch_fn(probes.reshape(k * (dim + 1), dim), key)
        fs = fs.reshape(k, dim + 1)
        f0 = fs[:, 0]
        g = (fs[:, 1:] - f0[:, None]) / eps_
        return f0, g, cs.reshape(k, dim + 1).sum(1).to(torch.int32)
    return grad


def make_wass_cost_batch(spec: ObjectiveSpec, bootstrap_reps: int = 5):
    """(xs (K, d), key) -> (costs (K,), fcalls (K,)): the Wasserstein
    robustness cost (qnewton.py:447-455), RIM_1 of ``bootstrap_reps``
    ham-noisy fidelities per controller, each call billed
    ``bootstrap_reps`` function calls.  All K * reps probes ride one lanes
    batch."""
    n = spec.h0.shape[-1]
    h0r = _real(spec.h0)
    fid_lanes = _make_fid_lanes(n, spec.in_spin, spec.out_spin)

    def cost(xs, key):
        k = xs.shape[0]
        dt = h0r.dtype
        zdiag, znn = _structured_draws_lanes(key, k * bootstrap_reps, n,
                                             spec.noise, dt, xs.device)
        xr = xs.repeat_interleave(bootstrap_reps, dim=0)      # (K*R, d)
        a = _assemble_lanes(h0r, xr, zdiag, znn)
        fids = fid_lanes(a, xr[:, n].abs().to(dt))
        fids = fids.clamp(0.0, 1.0).reshape(k, bootstrap_reps)
        return wd_from_ideal(fids), torch.full(
            (k,), bootstrap_reps, dtype=torch.int32, device=xs.device)
    return cost
