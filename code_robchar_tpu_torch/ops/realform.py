"""Plain torch Jacobi eigensolvers, transfer amplitudes and the exact
gradient, lanes layout (counterpart of code_robchar_tpu/ops/realform.py).

These are the plain versions of the CUDA kernels in ops/cuda_jacobi.py:
the CPU path of the dispatch, the f64 parity path of the tests, and what
the kernels are held against on the card.  Arrays keep the JAX package's
lanes layout — the batch last, matrices of shape (n, n, B) — and every
operation is vectorised over the batch.

Two halves:

- split-complex Hermitian (the MC characterisation path):
  ``fidelity_herm_lanes``.  Each pivot (p, q) is the symmetric update of
  ``_herm_rotate_lanes`` and ``pallas_jacobi._rotation_body``: only columns
  p, q are rotated, rows p, q are their conjugate mirrors, and the 2x2
  pivot block is closed-form (A'[p,q] = 0, A'[p,p] = app - t|apq|,
  A'[q,q] = aqq + t|apq|).  Only the in and out eigenvector rows are
  carried, and phi = sum_k V[out,k] e^{-i t lam_k} conj(V[in,k]).
- real symmetric (the optimizer zoo's training path):
  ``jacobi_eigh_sym_lanes``, ``transfer_amp_sym_lanes``,
  ``fidelity_sym_lanes`` and ``infidelity_and_gradient_sym_lanes`` (the
  Daleckii-Krein gradient in its sinc form), with the same symmetric
  update as ``_sym_rotate_lanes`` and ``pallas_jacobi._sym_apply``; plus
  the per-controller forms ``jacobi_eigh_sym``,
  ``fidelity_from_controller_sym`` and ``infidelity_and_gradient_sym``,
  which run through the lanes functions with the batch moved last.

The single-matrix functions of the JAX module, on (..., n, n) arrays in
its cyclic order: ``jacobi_eigh_herm``, ``fidelity_sym``,
``fidelity_herm`` (both from the in and out eigenvector rows,
``_sym_eigh_rows`` / ``_herm_eigh_rows``) and ``split_hermitian``; they
run the lanes sweeps above with the batch moved last.

``order="cyclic"`` is the row-major pivot order of the JAX lanes
functions; ``order="roundrobin"`` is the circle-method stage order of the
Pallas kernels (and of the CUDA kernels), with each stage's angles
computed before its rotations — exact, since a stage's pivots are
disjoint.
"""

from __future__ import annotations

import torch


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, stable through x = 0 (series below |x| < 1e-3)."""
    small = x.abs() < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x * (1.0 / 6.0), torch.sin(xs) / xs)


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


def _herm_sweeps(ar, ai, vr, vi, sweeps, order):
    """``sweeps`` Hermitian Jacobi sweeps on ``ar``, ``ai`` (n, n, B), in
    place, carrying the eigenvector rows ``vr``, ``vi`` (R, n, B)."""
    n = ar.shape[0]
    eps = _eps_for(ar.dtype)
    schedule = pair_schedule(n, order)
    rows = {(p, q): torch.tensor([i for i in range(n) if i not in (p, q)],
                                 dtype=torch.long, device=ar.device)
            for stage in schedule for (p, q) in stage}
    for _ in range(sweeps):
        for stage in schedule:
            angs = [_angles(ar, ai, p, q, eps) for (p, q) in stage]
            for (p, q), ang in zip(stage, angs):
                _apply(ar, ai, vr, vi, p, q, rows[p, q], ang)


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
    ar = ar.clone()
    ai = ai.clone()
    vr = torch.zeros((2, n, b), dtype=ar.dtype, device=ar.device)
    vr[0, in_spin] = 1.0
    vr[1, out_spin] = 1.0
    vi = torch.zeros_like(vr)

    _herm_sweeps(ar, ai, vr, vi, sweeps, order)

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


# --------------------------------------------------------------------------
# real symmetric half (the optimizer zoo's training path)
# --------------------------------------------------------------------------

def _sym_angles(a, p, q, eps):
    """Rotation for pivot (p, q) of a real symmetric lanes matrix
    (``pallas_jacobi._sym_angles``; inactive lanes get the identity).  The
    pivot entries are returned as views, which only the rotation at (p, q)
    overwrites."""
    app, aqq, apq = a[p, p], a[q, q], a[p, q]
    r = apq.abs()
    active = r > eps * (app.abs() + aqq.abs() + r)
    safe = torch.where(active, apq, 1.0)
    tau = (aqq - app) / (2.0 * safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(active, c, 1.0)
    s = torch.where(active, s, 0.0)
    t_eff = torch.where(active, t, 0.0)
    return c, s, t_eff, apq, app, aqq, active


def _sym_apply(a, v, p, q, ang):
    """Symmetric-update rotation at pivot (p, q), in place
    (``_sym_rotate_lanes``): rotate columns p, q, mirror them into rows
    p, q, write the pivot block in closed form, rotate the carried rows
    ``v`` (R, n, B)."""
    c, s, t_eff, apq, app, aqq, active = ang
    npp = app - t_eff * apq          # the pivot block, before its entries
    nqq = aqq + t_eff * apq          # are overwritten below
    z = torch.where(active, 0.0, apq)
    cp, cq = a[:, p], a[:, q]
    ncp = c * cp - s * cq
    ncq = s * cp + c * cq
    a[:, p], a[:, q] = ncp, ncq
    a[p], a[q] = ncp, ncq
    a[p, p], a[q, q] = npp, nqq
    a[p, q], a[q, p] = z, z
    wp, wq = v[:, p], v[:, q]
    nwp = c * wp - s * wq
    nwq = s * wp + c * wq
    v[:, p], v[:, q] = nwp, nwq


def _sym_sweeps(a, v, sweeps, order):
    """``sweeps`` Jacobi sweeps on ``a`` (n, n, B), in place, carrying the
    eigenvector rows ``v`` (R, n, B)."""
    eps = _eps_for(a.dtype)
    schedule = pair_schedule(a.shape[0], order)
    for _ in range(sweeps):
        for stage in schedule:
            angs = [_sym_angles(a, p, q, eps) for (p, q) in stage]
            for (p, q), ang in zip(stage, angs):
                _sym_apply(a, v, p, q, ang)


def jacobi_eigh_sym_lanes(a: torch.Tensor, sweeps: int | None = None,
                          order: str = "roundrobin"):
    """Full eigendecomposition of real symmetric lanes matrices: a (n, n, B)
    -> (lam (n, B) unsorted, v (n, n, B)) with v[r, k] the r-th component
    of eigenvector k, A = V diag(lam) V^T.  The input is not modified."""
    n, b = a.shape[0], a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device)[:, :, None] \
        .expand(n, n, b).clone()
    _sym_sweeps(a, v, sweeps, order)
    idx = torch.arange(n, device=a.device)
    return a[idx, idx], v


def transfer_amp_sym_lanes(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                           out_spin: int, sweeps: int | None = None,
                           order: str = "roundrobin"):
    """Split transfer amplitude <out| exp(-i t A) |in> for real symmetric
    lanes matrices: a (n, n, B), t (B,) -> (phr, phi), each (B,).  Only the
    in and out eigenvector rows are carried.  The inputs are not
    modified."""
    n, b = a.shape[0], a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    a = a.clone()
    v = torch.zeros((2, n, b), dtype=a.dtype, device=a.device)
    v[0, in_spin] = 1.0
    v[1, out_spin] = 1.0
    _sym_sweeps(a, v, sweeps, order)
    phr = torch.zeros_like(t)
    phi = torch.zeros_like(t)
    for k in range(n):
        w = v[0, k] * v[1, k]
        ang = a[k, k] * t
        phr = phr + w * torch.cos(ang)
        phi = phi - w * torch.sin(ang)
    return phr, phi


def fidelity_sym_lanes(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                       out_spin: int, sweeps: int | None = None,
                       order: str = "roundrobin") -> torch.Tensor:
    """Batched |<out| exp(-i t A) |in>|^2, real symmetric lanes layout:
    a (n, n, B), t (B,) -> (B,)."""
    phr, phi = transfer_amp_sym_lanes(a, t, in_spin, out_spin, sweeps, order)
    return phr * phr + phi * phi


def infidelity_and_gradient_sym_lanes(h0: torch.Tensor, xs: torch.Tensor,
                                      in_spin: int, out_spin: int,
                                      sweeps: int | None = None,
                                      order: str = "roundrobin"):
    """Batched exact (infidelity, gradient): h0 (n, n) real symmetric drift,
    xs (B, n+1) controllers (biases, then the time T = |x[n]|) ->
    (err (B,), grad (B, n+1)).

    err = 1 - |phi|^2; the gradient w.r.t. the biases is the
    Daleckii-Krein contraction with the split matrix
    Gamma_jk = -i t e^{-i t (l_j + l_k)/2} sinc(t (l_j - l_k)/2), which has
    no cancellation at any eigenvalue gap (``realform._gamma_parts``); the
    one w.r.t. T is -2 Im((H U)[out, in] conj(phi))."""
    n = h0.shape[-1]
    b = xs.shape[0]
    dt = h0.dtype
    biases = xs[:, :n].to(dt)
    t = xs[:, n].abs().to(dt)
    a = h0[:, :, None].expand(n, n, b).clone()
    idx = torch.arange(n, device=h0.device)
    a[idx, idx] = a[idx, idx] + biases.T
    lam, v = jacobi_eigh_sym_lanes(a, sweeps, order)

    v_out, v_in = v[out_spin], v[in_spin]                   # (n, B)
    w = v_out * v_in
    ang = lam * t
    fr, fi = torch.cos(ang), -torch.sin(ang)
    phr = (w * fr).sum(0)
    phi = (w * fi).sum(0)
    err = 1.0 - (phr * phr + phi * phi)

    dl = lam[:, None, :] - lam[None, :, :]
    mid = 0.5 * (lam[:, None, :] + lam[None, :, :])
    mang = mid * t
    s = _sinc(0.5 * dl * t)
    gr = -t * s * torch.sin(mang)
    gi = -t * s * torch.cos(mang)
    a_lj = v_out[None] * v                                  # (l, j, B)
    b_lk = v * v_in[None]                                   # (l, k, B)
    dphr = torch.einsum("ljb,jkb,lkb->lb", a_lj, gr, b_lk)
    dphi = torch.einsum("ljb,jkb,lkb->lb", a_lj, gi, b_lk)
    grad_bias = -2.0 * (dphr * phr + dphi * phi)

    hur = (lam * w * fr).sum(0)
    hui = (lam * w * fi).sum(0)
    grad_t = -2.0 * (hui * phr - hur * phi)
    return err, torch.cat([grad_bias.T, grad_t[:, None]], dim=1)


#: lanes per matrix of the lane-group kernels (kGroupLanes of
#: csrc/jacobi_common.cuh)
GROUP_LANES = 4


def group_layout(n: int) -> dict:
    """The compile-time tables of the lane-group kernels
    (csrc/jacobi_common.cuh ``group_sweeps``, sym_jacobi_amp.cu,
    sym_jacobi_grad.cu) for n x n matrices, mirrored in Python:

    - ``lanes``: L, the lanes of one matrix: GROUP_LANES, at most one per
      slot of a stage (M/2 with M = n, or n + 1 when n is odd);
      ``per_warp``: the matrices of one warp, 32 // L;
    - ``stages``: per stage, per slot the pivot (p, q), p < q, or None for
      the slot of the bye, from the kernels' closed form of the
      circle-method tournament; ``slot_lanes``: slot k -> (lane, register)
      = (k % L, k // L), the lane that computes its angles;
    - ``rows``: the gradient kernel's deal of V's rows, row l -> (lane,
      register row) = (l % L, l // L); the phase factors are dealt alike;
    - ``pairs``: the pairs (j, k), j <= k, of the Daleckii-Krein
      contraction in row-major order, and ``pair_lanes``: pair number q ->
      (lane, register) = (q % L, q // L)."""
    m = n + (n & 1)
    slots = m // 2
    g = min(GROUP_LANES, slots)

    def player(s, j):
        return 0 if j == 0 else 1 + (j - 1 - s) % (m - 1)

    stages = []
    for s in range(m - 1):
        stage = []
        for k in range(slots):
            a, b = player(s, k), player(s, m - 1 - k)
            stage.append(None if max(a, b) >= n else (min(a, b), max(a, b)))
        stages.append(stage)
    pairs = [(j, k) for j in range(n) for k in range(j, n)]
    return {"lanes": g, "per_warp": 32 // g, "stages": stages,
            "slot_lanes": [(k % g, k // g) for k in range(slots)],
            "rows": [(l % g, l // g) for l in range(n)], "pairs": pairs,
            "pair_lanes": [(q % g, q // g) for q in range(len(pairs))]}


def _to_lanes(m: torch.Tensor) -> torch.Tensor:
    """(..., n, n) -> (n, n, prod(...)) with the batch last."""
    n = m.shape[-1]
    return m.reshape(-1, n, n).permute(1, 2, 0).contiguous()


def jacobi_eigh_sym(a: torch.Tensor, sweeps: int | None = None):
    """Eigendecomposition of real symmetric (..., n, n), cyclic order, as
    JAX ``realform.jacobi_eigh_sym``: (lam (..., n) ascending,
    v (..., n, n)) with the eigenvectors as columns."""
    n = a.shape[-1]
    lead = a.shape[:-2]
    lam, v = jacobi_eigh_sym_lanes(_to_lanes(a), sweeps, order="cyclic")
    lam = lam.T.reshape(lead + (n,))
    v = v.permute(2, 0, 1).reshape(lead + (n, n))
    srt = torch.argsort(lam, dim=-1, stable=True)
    return (torch.take_along_dim(lam, srt, dim=-1),
            torch.take_along_dim(v, srt[..., None, :], dim=-1))


def fidelity_from_controller_sym(h0: torch.Tensor, x: torch.Tensor,
                                 in_spin: int, out_spin: int) -> torch.Tensor:
    """The reference objective contract, H = H0 + diag(x[:n]) and
    T = |x[n]|, on the real symmetric path (cyclic order): h0 (..., n, n)
    and x (..., n+1) broadcast; returns the fidelity of shape (...)."""
    n = h0.shape[-1]
    h = h0 + torch.eye(n, dtype=h0.dtype, device=h0.device) \
        * x[..., None, :n].to(h0.dtype)
    t = x[..., n].abs().to(h0.dtype)
    lead = torch.broadcast_shapes(h.shape[:-2], t.shape)
    h = h.expand(lead + (n, n))
    fid = fidelity_sym_lanes(_to_lanes(h), t.expand(lead).reshape(-1),
                             in_spin, out_spin, order="cyclic")
    return fid.reshape(lead)


def infidelity_and_gradient_sym(h0: torch.Tensor, x: torch.Tensor,
                                in_spin: int, out_spin: int):
    """Exact (infidelity, gradient) for one controller x (n+1,) or a batch
    (..., n+1) under the drift h0 (n, n), cyclic order:
    (err (...), grad (..., n+1))."""
    n = h0.shape[-1]
    lead = x.shape[:-1]
    err, grad = infidelity_and_gradient_sym_lanes(
        h0, x.reshape(-1, n + 1), in_spin, out_spin, order="cyclic")
    return err.reshape(lead), grad.reshape(lead + (n + 1,))


# --------------------------------------------------------------------------
# single-matrix functions (..., n, n): the JAX package's cyclic order,
# through the lanes sweeps above with the batch moved last
# --------------------------------------------------------------------------

def _from_lanes(x: torch.Tensor, lead) -> torch.Tensor:
    """(..., B) lanes tensor -> (B, ...) reshaped to ``lead + (...)``."""
    return x.permute(-1, *range(x.dim() - 1)).reshape(
        tuple(lead) + tuple(x.shape[:-1]))


def _row_select(rows, n, b, dtype, device) -> torch.Tensor:
    sel = torch.zeros((len(rows), n, b), dtype=dtype, device=device)
    for r, row in enumerate(rows):
        sel[r, row] = 1.0
    return sel


def _sym_eigh_rows(a: torch.Tensor, rows, sweeps: int | None = None):
    """(lam unsorted (..., n), vrows (..., R, n)) of real symmetric
    (..., n, n), with vrows[..., r, :] = V[rows[r], :]."""
    n, lead = a.shape[-1], a.shape[:-2]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    la = _to_lanes(a).clone()
    v = _row_select(rows, n, la.shape[-1], a.dtype, a.device)
    _sym_sweeps(la, v, sweeps, "cyclic")
    idx = torch.arange(n, device=a.device)
    return _from_lanes(la[idx, idx], lead), _from_lanes(v, lead)


def _herm_eigh_rows(ar: torch.Tensor, ai: torch.Tensor, rows,
                    sweeps: int | None = None):
    """(lam unsorted (..., n), vr_rows, vi_rows (..., R, n)) of the
    Hermitian A = ar + i ai, given as its split parts (..., n, n)."""
    n, lead = ar.shape[-1], ar.shape[:-2]
    if sweeps is None:
        sweeps = _sweeps_for(ar.dtype, n)
    lr, li = _to_lanes(ar).clone(), _to_lanes(ai).clone()
    vr = _row_select(rows, n, lr.shape[-1], ar.dtype, ar.device)
    vi = torch.zeros_like(vr)
    _herm_sweeps(lr, li, vr, vi, sweeps, "cyclic")
    idx = torch.arange(n, device=ar.device)
    return (_from_lanes(lr[idx, idx], lead), _from_lanes(vr, lead),
            _from_lanes(vi, lead))


def jacobi_eigh_herm(ar: torch.Tensor, ai: torch.Tensor,
                     sweeps: int | None = None):
    """Eigendecomposition of the Hermitian A = ar + i ai given as split
    parts (..., n, n), cyclic order: (lam (..., n) ascending, vr, vi
    (..., n, n)) with the eigenvectors as columns."""
    n = ar.shape[-1]
    lam, vr, vi = _herm_eigh_rows(ar, ai, range(n), sweeps)
    srt = torch.argsort(lam, dim=-1, stable=True)

    def take(m):
        return torch.take_along_dim(m, srt[..., None, :], dim=-1)
    return torch.take_along_dim(lam, srt, dim=-1), take(vr), take(vi)


def _phase_parts(lam: torch.Tensor, t) -> tuple:
    """e^{-i t lam} as (cos(t lam), -sin(t lam))."""
    ang = lam * torch.as_tensor(t, dtype=lam.dtype,
                                device=lam.device)[..., None]
    return torch.cos(ang), -torch.sin(ang)


def fidelity_sym(h: torch.Tensor, t, in_spin: int, out_spin: int,
                 eigh_sym=None) -> torch.Tensor:
    """|<out| exp(-i t H) |in>|^2 for real symmetric H (..., n, n), from
    the in and out eigenvector rows (or from ``eigh_sym(h) -> (lam, v)``
    when given)."""
    if eigh_sym is not None:
        lam, v = eigh_sym(h)
        v_out, v_in = v[..., out_spin, :], v[..., in_spin, :]
    else:
        lam, vrows = _sym_eigh_rows(h, (in_spin, out_spin))
        v_in, v_out = vrows[..., 0, :], vrows[..., 1, :]
    w = v_out * v_in
    cr, ci = _phase_parts(lam, t)
    phr = torch.sum(w * cr, dim=-1)
    phi = torch.sum(w * ci, dim=-1)
    return phr * phr + phi * phi


def fidelity_herm(ar: torch.Tensor, ai: torch.Tensor, t, in_spin: int,
                  out_spin: int, eigh_herm=None) -> torch.Tensor:
    """|<out| exp(-i t (ar + i ai)) |in>|^2 in split arithmetic (..., n, n):
    phi = sum_k a_k f_k conj(b_k) with a = V[out, :], b = V[in, :] and
    f = e^{-i t lam}, expanded into real products."""
    if eigh_herm is not None:
        lam, vr, vi = eigh_herm(ar, ai)
        aor, aoi = vr[..., out_spin, :], vi[..., out_spin, :]
        bir, bii = vr[..., in_spin, :], vi[..., in_spin, :]
    else:
        lam, vrr, vir = _herm_eigh_rows(ar, ai, (in_spin, out_spin))
        bir, bii = vrr[..., 0, :], vir[..., 0, :]
        aor, aoi = vrr[..., 1, :], vir[..., 1, :]
    gr = aor * bir + aoi * bii                  # g = a * conj(b)
    gi = aoi * bir - aor * bii
    fr, fi = _phase_parts(lam, t)
    phr = torch.sum(gr * fr - gi * fi, dim=-1)
    phi = torch.sum(gr * fi + gi * fr, dim=-1)
    return phr * phr + phi * phi


def split_hermitian(h: torch.Tensor):
    """Complex Hermitian -> (real, imag) parts; a real h has a zero
    imaginary part."""
    h = torch.as_tensor(h)
    if not h.is_complex():
        return h, torch.zeros_like(h)
    return h.real, h.imag
