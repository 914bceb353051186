"""Structured noise and the lanes-layout Hamiltonian assembly
(counterpart of code_robchar_tpu/ops/noise.py and of the assembly in
code_robchar_tpu/mc/engine._chunk_kernel_lanes).

Every draw is a pure function of an explicit threefry key (ops/prng.py),
with the key split and draw order of the JAX package: ``split(key, 3)``
gives the keys of the diagonal, the real nearest-neighbour couplings and
the imaginary ones, in that order, so the port draws the same numbers as
the reference for the same key.  Keys may carry leading batch dimensions.
"""

from __future__ import annotations

import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.ops import prng


def _draws(key, n, scale, rdt, complex_offdiag):
    """(diag (..., n), nn (..., n-1), nn2 (..., n-1) or None), each scaled.

    One normal draw of width n per split key: a draw of width n-1 under
    the same key is the first n-1 entries of it (element i uses counter
    i), so the three draws share one threefry pass."""
    ks = prng.split(key, 3)[..., :3 if complex_offdiag else 2, :]
    scale = torch.as_tensor(scale, dtype=rdt, device=key.device)
    z = prng.normal(ks, (n,), rdt) * scale[..., None, None]
    nn2 = z[..., 2, :n - 1] if complex_offdiag else None
    return z[..., 0, :], z[..., 1, :n - 1], nn2


def structured_perturbation(key: torch.Tensor, n: int, scale,
                            complex_offdiag: bool = True,
                            dtype: torch.dtype = torch.complex64
                            ) -> torch.Tensor:
    """Structured Gaussian perturbation of an XX-chain Hamiltonian,
    (..., n, n) for keys (..., 2).

    z[i,i] ~ N(0, scale); nearest-neighbour couplings nn ~ N(0, scale)
    and, when ``complex_offdiag``, nn2 ~ N(0, scale) with
    z[i,i-1] = nn + i nn2 and z[i-1,i] = nn - i nn2 (noise_model.py:135-147);
    otherwise the real training-side variant."""
    diag, nn, nn2 = _draws(key, n, scale, config.real_dtype(dtype),
                           complex_offdiag)
    off = torch.complex(nn, nn2) if complex_offdiag else nn
    z = torch.zeros(diag.shape[:-1] + (n, n), dtype=dtype,
                    device=key.device)
    i = torch.arange(n, device=key.device)
    z[..., i, i] = diag.to(dtype)
    z[..., i[1:], i[:-1]] = off.to(dtype)
    z[..., i[:-1], i[1:]] = off.conj().to(dtype)
    return z


def structured_perturbation_parts(key: torch.Tensor, n: int, scale,
                                  complex_offdiag: bool = True,
                                  dtype: torch.dtype = torch.float32):
    """Split-real form of ``structured_perturbation``: (zr, zi) with zr
    symmetric and zi antisymmetric (+nn2 at (i, i-1), -nn2 at (i-1, i)),
    the same draws as the complex form under the same key."""
    diag, nn, nn2 = _draws(key, n, scale, dtype, complex_offdiag)
    zr = torch.zeros(diag.shape[:-1] + (n, n), dtype=dtype,
                     device=key.device)
    zi = torch.zeros_like(zr)
    i = torch.arange(n, device=key.device)
    zr[..., i, i] = diag
    zr[..., i[1:], i[:-1]] = nn
    zr[..., i[:-1], i[1:]] = nn
    if complex_offdiag:
        zi[..., i[1:], i[:-1]] = nn2
        zi[..., i[:-1], i[1:]] = -nn2
    return zr, zi


def assemble_lanes(h0r: torch.Tensor, xs: torch.Tensor, scales: torch.Tensor,
                   keys: torch.Tensor, complex_offdiag: bool = True):
    """Perturbed, biased Hamiltonians in the lanes layout.

    h0r (n, n) real drift, xs (B, n+1) controllers (biases, then the time),
    scales (B,) noise levels, keys (B, 2) per-element keys ->
    (ar (n, n, B), ai (n, n, B), t (B,)): h0 + diagonal noise + biases on
    the diagonal, symmetric real and antisymmetric imaginary
    nearest-neighbour couplings, and t = |x[n]|."""
    n = h0r.shape[-1]
    b = xs.shape[0]
    diag, nn, nn2 = _draws(keys, n, scales, h0r.dtype, complex_offdiag)
    i = torch.arange(n, device=h0r.device)
    lo, hi = i[1:], i[:-1]
    ar = h0r[:, :, None].expand(n, n, b).clone()
    ar[i, i] = ar[i, i] + (diag + xs[:, :n]).T
    ar[lo, hi] = ar[lo, hi] + nn.T
    ar[hi, lo] = ar[hi, lo] + nn.T
    ai = torch.zeros_like(ar)
    if complex_offdiag:
        ai[lo, hi] = nn2.T
        ai[hi, lo] = -nn2.T
    return ar, ai, xs[:, n].abs()


def fixed_hamiltonian_ensemble(key: torch.Tensor, h0: torch.Tensor, scale,
                               train_size: int = 100, test_size: int = 10000,
                               complex_offdiag: bool = False):
    """Pre-drawn perturbed-Hamiltonian train and test sets of the
    fixed-ensemble objective (qnewton.py:122-137): (train (train_size, n, n),
    test (test_size, n, n)), each h0 + structured_perturbation.  The
    reference's seed contract is ``key = prng.key(4)``; the two sets come
    from ``split(key)`` and then ``split(k, size)``, as in the JAX
    package, so the same key gives the same ensembles."""
    n = h0.shape[-1]
    k1, k2 = prng.split(key.to(h0.device))

    def draw(k, size):
        return h0 + structured_perturbation(
            prng.split(k, size), n, scale, complex_offdiag=complex_offdiag,
            dtype=h0.dtype)

    return draw(k1, train_size), draw(k2, test_size)
