"""Plain torch transfer fidelity by split-complex Jacobi, lanes layout
(counterpart of code_robchar_tpu/ops/realform.py, Hermitian lanes path).

This is the plain version of the CUDA kernel in ops/cuda_jacobi.py: the
CPU path of the dispatch, the f64 parity path of the tests, and what
the kernel is held against on the card.  Arrays keep the JAX package's
lanes layout — the batch last, ``ar``/``ai`` of shape (n, n, B) — and
every operation is vectorised over the batch.

Each pivot (p, q) is the symmetric update of ``_herm_rotate_lanes`` and
``pallas_jacobi._rotation_body``: only columns p, q are rotated, rows
p, q are their conjugate mirrors, and the 2x2 pivot block is closed-form
(A'[p,q] = 0, A'[p,p] = app - t|apq|, A'[q,q] = aqq + t|apq|).  Only the
in and out eigenvector rows are carried, and the amplitude is
phi = sum_k V[out,k] e^{-i t lam_k} conj(V[in,k]).

``order="cyclic"`` is the row-major pivot order of JAX
``realform.fidelity_herm_lanes``; ``order="roundrobin"`` is the
circle-method stage order of the Pallas kernel (and of the CUDA kernel),
with each stage's angles computed before its rotations — exact, since a
stage's pivots are disjoint.
"""

from __future__ import annotations

import torch


def _sweeps_for(dtype: torch.dtype, n: int) -> int:
    """Sweep policy of the reference: f32 5 (6 for n > 8), f64 9 (11)."""
    if dtype == torch.float32:
        return 5 + (1 if n > 8 else 0)
    return 9 + (2 if n > 8 else 0)


def _eps_for(dtype: torch.dtype) -> float:
    return 1e-7 if dtype == torch.float32 else 1e-15


def pair_schedule(n: int, order: str = "roundrobin"):
    """Sweep schedule as a list of stages of disjoint (p, q) pivots.

    "cyclic": row-major order, one pair per stage.  "roundrobin":
    circle-method tournament — each stage's pairs are pairwise disjoint
    and each sweep covers all n(n-1)/2 pairs exactly once."""
    if order == "cyclic":
        return [[(p, q)] for p in range(n - 1) for q in range(p + 1, n)]
    if order != "roundrobin":
        raise ValueError(f"unknown rotation order {order!r}")
    players = list(range(n)) + ([None] if n % 2 else [])
    m = len(players)
    stages, arr = [], players[:]
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = arr[i], arr[m - 1 - i]
            if a is not None and b is not None:
                pairs.append((min(a, b), max(a, b)))
        stages.append(pairs)
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return stages


def _angles(ar, ai, p, q, eps):
    """Rotation for pivot (p, q) from the current entries (Rutishauser
    stable form; inactive lanes get the identity)."""
    app = ar[p, p]
    aqq = ar[q, q]
    xr = ar[p, q]
    xi = ai[p, q]
    r = torch.sqrt(xr * xr + xi * xi)
    active = r > eps * (app.abs() + aqq.abs() + r)
    safe = torch.where(active, r, 1.0)
    pr = torch.where(active, xr / safe, 1.0)
    pi = torch.where(active, xi / safe, 0.0)
    tau = (aqq - app) / (2.0 * safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(active, c, 1.0)
    s = torch.where(active, s, 0.0)
    t_eff = torch.where(active, t, 0.0)
    return pr, pi, c, s, t_eff, r, xr, xi, app, aqq, active


def _cmul(xr, xi, yr, yi):
    return xr * yr - xi * yi, xr * yi + xi * yr


def _apply(ar, ai, vr, vi, p, q, rows, ang):
    """Symmetric-update rotation at pivot (p, q), in place; ``rows`` are
    the indices other than p and q."""
    pr, pi, c, s, t_eff, r, xr, xi, app, aqq, active = ang
    cpr, cpi = ar[rows, p], ai[rows, p]
    cqr, cqi = ar[rows, q], ai[rows, q]
    tr, ti = _cmul(pr, -pi, cqr, cqi)
    npr, npi = c * cpr - s * tr, c * cpi - s * ti
    tr, ti = _cmul(pr, pi, cpr, cpi)
    nqr, nqi = s * tr + c * cqr, s * ti + c * cqi
    ar[rows, p], ai[rows, p] = npr, npi
    ar[p, rows], ai[p, rows] = npr, -npi
    ar[rows, q], ai[rows, q] = nqr, nqi
    ar[q, rows], ai[q, rows] = nqr, -nqi
    # closed-form pivot block; the imaginary diagonal stays zero
    zr = torch.where(active, 0.0, xr)
    zi = torch.where(active, 0.0, xi)
    ar[p, p] = app - t_eff * r
    ar[q, q] = aqq + t_eff * r
    ar[p, q], ar[q, p] = zr, zr
    ai[p, q], ai[q, p] = zi, -zi
    # carried eigenvector rows: V <- V J
    wpr, wpi = vr[:, p], vi[:, p]
    wqr, wqi = vr[:, q], vi[:, q]
    tr, ti = _cmul(pr, -pi, wqr, wqi)
    nvpr, nvpi = c * wpr - s * tr, c * wpi - s * ti
    tr, ti = _cmul(pr, pi, wpr, wpi)
    vr[:, q], vi[:, q] = s * tr + c * wqr, s * ti + c * wqi
    vr[:, p], vi[:, p] = nvpr, nvpi


def fidelity_herm_lanes(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                        in_spin: int, out_spin: int, sweeps: int | None = None,
                        order: str = "roundrobin") -> torch.Tensor:
    """Batched |<out| exp(-i t A) |in>|^2 with A = ar + i ai Hermitian, in
    lanes layout: ar/ai (n, n, B), t (B,) -> (B,).  The inputs are not
    modified."""
    n = ar.shape[0]
    b = ar.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(ar.dtype, n)
    eps = _eps_for(ar.dtype)
    ar = ar.clone()
    ai = ai.clone()
    vr = torch.zeros((2, n, b), dtype=ar.dtype, device=ar.device)
    vr[0, in_spin] = 1.0
    vr[1, out_spin] = 1.0
    vi = torch.zeros_like(vr)

    schedule = pair_schedule(n, order)
    rows = {(p, q): torch.tensor([i for i in range(n) if i not in (p, q)],
                                 dtype=torch.long, device=ar.device)
            for stage in schedule for (p, q) in stage}
    for _ in range(sweeps):
        for stage in schedule:
            angs = [_angles(ar, ai, p, q, eps) for (p, q) in stage]
            for (p, q), ang in zip(stage, angs):
                _apply(ar, ai, vr, vi, p, q, rows[p, q], ang)

    phr = torch.zeros_like(t)
    phi = torch.zeros_like(t)
    for k in range(n):
        gr = vr[1, k] * vr[0, k] + vi[1, k] * vi[0, k]
        gi = vi[1, k] * vr[0, k] - vr[1, k] * vi[0, k]
        ang = ar[k, k] * t
        fr = torch.cos(ang)
        fi = -torch.sin(ang)
        phr = phr + gr * fr - gi * fi
        phi = phi + gr * fi + gi * fr
    return phr * phr + phi * phi
