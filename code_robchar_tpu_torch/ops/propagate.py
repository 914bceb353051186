"""Propagators and transfer fidelities by a complex eigendecomposition
(counterpart of the fidelity half of code_robchar_tpu/ops/propagate.py).

Every Hamiltonian here is Hermitian, so the propagator is exact in the
eigenbasis: U = V exp(-i T diag(lam)) V^H, through a batched
``torch.linalg.eigh`` on the tensors' device (LAPACK on the CPU, the
library's solver on the card).  This is the engine's LAPACK parity path,
``use_jacobi=False`` (code_robchar_tpu/mc/engine.py:56-66): an oracle beside
the Jacobi kernel, not the throughput route.  The card's fidelities run on
the Jacobi kernels (ops/cuda_jacobi.py, models/objectives.py).  The gradient
half (``infidelity_and_gradient``, ``overlap_ss``) is not ported here: the
zoo's gradients run on the real-symmetric Jacobi (ops/realform.py,
ops/cuda_jacobi.py).
"""

from __future__ import annotations

import torch


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
