"""Propagators, transfer fidelities and the exact gradient by a complex
eigendecomposition (counterpart of code_robchar_tpu/ops/propagate.py).

Every Hamiltonian here is Hermitian, so the propagator is exact in the
eigenbasis: U = V exp(-i T diag(lam)) V^H, through a batched
``torch.linalg.eigh`` on the tensors' device (LAPACK on the CPU, the
library's solver on the card).  This is the engine's LAPACK parity path,
``use_jacobi=False`` (code_robchar_tpu/mc/engine.py:56-66): an oracle beside
the Jacobi kernel, not the throughput route.  The card's fidelities run on
the Jacobi kernels (ops/cuda_jacobi.py, models/objectives.py).

The gradient half (``infidelity_and_gradient``, ``overlap_ss``) is the
complex oracle of the real-symmetric Jacobi gradient, which is what the
zoo runs (ops/realform.py, ops/cuda_jacobi.py): the exact Daleckii-Krein
gradient in the eigenbasis, with the divided differences of
f(l) = exp(-i t l) in their cancellation-free form
Gamma_jk = -i t exp(-i t (l_j + l_k)/2) sinc(t (l_j - l_k)/2).  Its
contractions run in full float32 on the card: config switches TF32 off.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

EighFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _phases(lam: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """exp(-i t lam) with lam real, t real (broadcastable)."""
    angle = -lam * t[..., None]
    return torch.complex(torch.cos(angle), torch.sin(angle))


def _as_real(t, lam: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=lam.dtype, device=lam.device)


def propagator(h: torch.Tensor, t) -> torch.Tensor:
    """U = exp(-i t H) for Hermitian H, shape (..., n, n)."""
    lam, v = torch.linalg.eigh(h)
    ph = _phases(lam, _as_real(t, lam))
    return torch.einsum("...ik,...k,...jk->...ij", v, ph, v.conj())


def _transfer_amplitude(h, t, in_spin, out_spin):
    """phi = <out| exp(-i t H) |in> = sum_k V[out,k] e^{-i t l_k}
    conj(V[in,k]), without forming U."""
    lam, v = torch.linalg.eigh(h)
    ph = _phases(lam, _as_real(t, lam))
    return torch.sum(v[..., out_spin, :] * ph * v[..., in_spin, :].conj(),
                     dim=-1)


def transfer_fidelity(h: torch.Tensor, t, in_spin: int, out_spin: int
                      ) -> torch.Tensor:
    """|<out| exp(-i t H) |in>|^2  (qnewton.py:397-400,
    noise_model.py:105-109)."""
    phi = _transfer_amplitude(h, t, in_spin, out_spin)
    return phi.real * phi.real + phi.imag * phi.imag


def fidelity_from_controller(h0: torch.Tensor, x: torch.Tensor,
                             in_spin: int, out_spin: int) -> torch.Tensor:
    """Fidelity of controller x = (biases[0:n], time): T = |x[n]|,
    H = H0 + diag(x[:n]) (qnewton.py:383-400).  ``h0`` may already include
    a noise perturbation.  Batched: h0 (..., n, n), x (..., n+1)."""
    n = h0.shape[-1]
    biases = x[..., :n]
    t = torch.abs(x[..., n])
    eye = torch.eye(n, dtype=h0.dtype, device=h0.device)
    h = h0 + eye * biases[..., None, :].to(h0.dtype)
    return transfer_fidelity(h, t, in_spin, out_spin)


def fidelity_batch(h0: torch.Tensor, xs: torch.Tensor, in_spin: int,
                   out_spin: int) -> torch.Tensor:
    """Fidelities of a (B, n+1) controller batch against one complex drift
    Hamiltonian (n, n), by the library's eigh: the parity path, not the
    card route.  The zoo's batch fidelities on the card go through
    ``models.objectives.fidelity_batch`` (the amplitude kernel)."""
    return fidelity_from_controller(h0, xs, in_spin, out_spin)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, stable through x = 0 (series below |x| < 1e-3: relative
    error <= x^4/120 ~ 8e-15)."""
    small = x.abs() < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x * (1.0 / 6.0), torch.sin(xs) / xs)


def _gamma_matrix(lam: torch.Tensor, t) -> torch.Tensor:
    """Daleckii-Krein divided-difference matrix of f(l) = exp(-i t l):
    Gamma_jk = (f(l_j) - f(l_k)) / (l_j - l_k), through the exact identity
    Gamma_jk = -i t exp(-i t (l_j+l_k)/2) sinc(t (l_j-l_k)/2), accurate at
    every eigenvalue gap (its limit at a degeneracy is -i t f(l_j))."""
    tc = _as_real(t, lam)[..., None, None]
    dl = lam[..., :, None] - lam[..., None, :]
    mid = 0.5 * (lam[..., :, None] + lam[..., None, :])
    angle = -mid * tc
    fmid = torch.complex(torch.cos(angle), torch.sin(angle))
    s = _sinc(0.5 * dl * tc)
    return -1j * (tc * s).to(fmid.dtype) * fmid


def _biased(h0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    n = h0.shape[-1]
    eye = torch.eye(n, dtype=h0.dtype, device=h0.device)
    return h0 + eye * x[..., None, :n].to(h0.dtype)


def infidelity_and_gradient(h0: torch.Tensor, x: torch.Tensor,
                            in_spin: int, out_spin: int,
                            eigh: EighFn = torch.linalg.eigh):
    """Exact infidelity and its gradient w.r.t. (biases, time), batched
    over the leading axes of h0 (..., n, n) and x (..., n+1):

      err        = 1 - |phi|^2,                  phi = <out|U|in>
      d err/dx_l = -2 Re(<out|dU_l|in> conj(phi)), dU_l = V (Gamma o M_l) V^H
      d err/dT   = -2 Im((H U)[out, in] conj(phi))

    with M_l = V^H e_l e_l^T V of rank one, so one weighted bilinear form
    a bias gives all n bias derivatives at once (qnewton.py:162-212
    ``eval_static_fidelity_gradient``; T = |x[n]| with no sign term,
    qnewton.py:175)."""
    n = h0.shape[-1]
    t = torch.abs(x[..., n])
    lam, v = eigh(_biased(h0, x))
    ph = _phases(lam, _as_real(t, lam))

    v_out = v[..., out_spin, :]
    v_in_c = v[..., in_spin, :].conj()
    phi = torch.sum(v_out * ph * v_in_c, dim=-1)
    err = 1.0 - (phi.real * phi.real + phi.imag * phi.imag)

    gamma = _gamma_matrix(lam, t)
    # A[l, j] = V[out, j] conj(V[l, j]);  B[l, k] = V[l, k] conj(V[in, k])
    a = v_out[..., None, :] * v.conj()
    b = v * v_in_c[..., None, :]
    dphi_bias = torch.einsum("...lj,...jk,...lk->...l", a, gamma, b)
    grad_bias = -2.0 * (dphi_bias * phi.conj()[..., None]).real

    # (H U)[out, in] = sum_k l_k V[out, k] e^{-i T l_k} conj(V[in, k])
    hu = torch.sum(lam.to(ph.dtype) * v_out * ph * v_in_c, dim=-1)
    grad_t = -2.0 * (hu * phi.conj()).imag
    return err, torch.cat([grad_bias, grad_t[..., None]], dim=-1)


def overlap_ss(h0: torch.Tensor, x: torch.Tensor, in_spin: int,
               out_spin: int, eigh: EighFn = torch.linalg.eigh
               ) -> torch.Tensor:
    """Steady-state overlap (qnewton.py:214-224): with rho0 = |in><in| and
    rho1 = |out><out| the reference's trace(diag(rho_ss) @ rho_out) is
    sum_k |V[in,k]|^2 |V[out,k]|^2 of H0 + diag(x[:n])."""
    _, v = eigh(_biased(h0, x))
    p_in = torch.abs(v[..., in_spin, :]) ** 2
    p_out = torch.abs(v[..., out_spin, :]) ** 2
    return torch.sum(p_in * p_out, dim=-1)
