"""Spin-chain Hamiltonian assembly (counterpart of code_robchar_tpu/ops/chain.py).

The single-excitation XX chain of length ``n`` has nearest-neighbour
couplings 1; a ``ring`` closes the chain; ``heisenberg=True`` adds the XXZ
diagonal ``t = 0.5*sum(triu(H))*ones - row_sums(H)`` (qnewton.py:148-150).
Controls are diagonal projectors, so adding a bias vector ``x`` is
``H + diag(x)``; the hot path inlines that expression in the lanes
layout (ops/noise.assemble_lanes).
"""

from __future__ import annotations

import numpy as np
import torch


def xx_hamiltonian(n: int, topo: str = "chain", heisenberg: bool = False,
                   dtype: torch.dtype = torch.complex64,
                   device=None) -> torch.Tensor:
    """Drift Hamiltonian of the length-``n`` XX chain; a real ``dtype``
    gives the real-symmetric form."""
    h = np.zeros((n, n), dtype=np.complex128)
    for l in range(1, n):
        h[l - 1, l] = 1.0
        h[l, l - 1] = 1.0
    if topo == "ring":
        h[n - 1, 0] = 1.0
        h[0, n - 1] = 1.0
    elif topo not in ("chain", "linear"):
        raise ValueError(f"unknown topology {topo!r}; use 'chain' or 'ring'")
    if heisenberg:
        t = 0.5 * np.triu(h).sum().real * np.ones(n) - np.sum(h, axis=1).real
        h = h + np.diag(t)
    if not dtype.is_complex:
        h = h.real
    return torch.as_tensor(h, device=device).to(dtype)


def xx_hamiltonian_real(n: int, topo: str = "chain",
                        heisenberg: bool = False,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """Real-symmetric drift for the lanes path."""
    return xx_hamiltonian(n, topo=topo, heisenberg=heisenberg, dtype=dtype,
                          device=device)


def basis_state(n: int, k: int, dtype: torch.dtype = torch.complex64,
                device=None) -> torch.Tensor:
    """Single-excitation basis vector |k>."""
    psi = torch.zeros(n, dtype=dtype, device=device)
    psi[k] = 1.0
    return psi


def control_projectors(n: int, dtype: torch.dtype = torch.complex64,
                       device=None) -> torch.Tensor:
    """Stacked diagonal projectors C[k] = e_k e_k^T, shape (n, n, n)."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return eye[:, :, None] * eye[:, None, :]


def add_bias(h: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """H + sum_l x_l C_l  ==  H + diag(x), batched over leading axes."""
    n = h.shape[-1]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    return h + eye * biases[..., None, :].to(h.dtype)
