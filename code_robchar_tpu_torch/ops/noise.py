"""Structured noise and the lanes-layout Hamiltonian assembly
(counterpart of code_robchar_tpu/ops/noise.py and of the assembly in
code_robchar_tpu/mc/engine._chunk_kernel_lanes).

Every draw is a pure function of an explicit threefry key (ops/prng.py),
with the key split and draw order of the JAX package: ``split(key, 3)``
gives the keys of the diagonal, the real nearest-neighbour couplings and
the imaginary ones, in that order, so the port draws the same numbers as
the reference for the same key.  Keys may carry leading batch dimensions.

The shot-noise protocols (``shot_noise_fidelity``,
``adaptive_shot_fidelity``) draw through ``prng.binomial``, which follows
``jax.random.binomial`` (qnewton.py:402-423 of the reference program).
"""

from __future__ import annotations

import math

import numpy as np
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


def _direction_table(n: int) -> torch.Tensor:
    """Hermitian-pair index table of ``directional_perturbation``
    (noise_model.py:155-163): the corners, the tridiagonal band of the
    interior sites, and the boundary off-diagonal pairs; (P, 2) int64."""
    dirs = [(0, 0), (n - 1, n - 1)]
    for d in range(1, n - 1):
        for o in (-1, 0, 1):
            dirs.append((d, d + o))
    dirs += [(0, 1), (1, 0), (n - 2, n - 1), (n - 1, n - 2)]
    return torch.tensor(dirs, dtype=torch.int64)


def directional_perturbation(key: torch.Tensor, n: int, scale,
                             dtype: torch.dtype = torch.complex64
                             ) -> torch.Tensor:
    """Perturb one randomly chosen Hermitian pair (noise_model.py:165-201):
    z[p] = a + i b and z[p^T] = a - i b with a, b ~ N(0, scale), (n, n) of
    ``dtype`` for one key (2,).  ``ki, kv = split(key)``: the pair's index
    is a ``randint`` from ki (64-bit words at complex128, as jax draws them
    under x64, 32-bit at complex64), a and b one normal draw of width 2
    from kv.  A diagonal pick holds conj(a + i b) alone: the reference
    assigns the value and then its conjugate to the same entry."""
    rdt = config.real_dtype(dtype)
    table = _direction_table(n)
    ki, kv = prng.split(key)
    idx = int(prng.randint(ki, (), 0, table.shape[0],
                           dtype=torch.int64 if rdt == torch.float64
                           else torch.int32))
    i, j = (int(v) for v in table[idx])
    ab = prng.normal(kv, (2,), rdt) * torch.as_tensor(scale, dtype=rdt)
    val = torch.complex(ab[0], ab[1]).to(dtype)
    z = torch.zeros((n, n), dtype=dtype, device=key.device)
    if i == j:
        z[i, i] = val.conj()
    else:
        z[i, j] = val
        z[j, i] = val.conj()
    return z


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


def shot_noise_fidelity(key: torch.Tensor, fid: torch.Tensor,
                        draws: int) -> torch.Tensor:
    """Finite-measurement fidelity Binomial(draws, fid) / draws
    (qnewton.py:407): one key and any fid, or a batch of keys (..., 2)
    and one fid per key (...), the JAX package's function vmapped over
    keys.

    The division is taken as the JAX package's compiled programs (the
    zoo's batch objectives, the PPO epoch) take it: XLA rewrites a division
    by a constant into the product with the constant's reciprocal, rounded
    to the dtype, so 7 shots of 10 read 0.7000000000000001 at float64.
    jnp outside jit, and ``draws`` passed as a traced value, divide
    exactly; the two differ by one ulp on some counts."""
    fid = torch.clamp(fid, 0.0, 1.0)
    sample = prng.binomial(key, draws, fid)
    npdt = np.float32 if fid.dtype == torch.float32 else np.float64
    return sample.to(fid.dtype) * float(npdt(1.0) / npdt(draws))


#: the most batches of shots drawn per pass of the adaptive protocol: the
#: batches' keys are a chain of splits, their draws one binomial call, and
#: the exit is read once a pass
ADAPTIVE_PASS = 16


def _adaptive_batches(draws: int, adp_tol: float) -> int:
    """Batches after which every element has stopped: var <= 1/4 / (a + b
    + draws + 1), and a + b = 1 + j * draws after j batches, whatever the
    shots (a pass that falls short by a rounding is followed by another)."""
    need = math.ceil((0.25 / adp_tol ** 2 - 2) / draws - 1)
    return max(1, min(ADAPTIVE_PASS, need))


def adaptive_shot_fidelity(key: torch.Tensor, fid: torch.Tensor, draws: int,
                           adp_tol: float):
    """The adaptive Bayesian shot protocol (qnewton.py:410-423) for a batch
    of keys (..., 2) and one fid per key (...): (estimate, calls), calls
    int32.

    A Beta posterior from a Jeffreys prior (a = b = 0.5): while the
    posterior std sqrt(var) exceeds ``adp_tol``, ``k, ks = split(k)`` and a
    batch of ``draws`` shots s ~ Binomial(draws, fid) from ks updates
    a += s, b += draws - s, the reference's running estimate mean =
    (a + s) / (a + b + draws), var = mean (1 - mean) / (a + b + draws + 1)
    and calls += draws.  Each element stops on its own, as under the JAX
    package's vmap: a finished element's state never changes again.  The
    recurrence is taken a pass of batches at a time (as many as any element
    can need, at most ``ADAPTIVE_PASS``): a and b are 0.5 plus sums of
    whole numbers, exact in any order, so the pass gives the loop's
    values."""
    if not adp_tol > 0:
        raise ValueError(f"adp_tol must be positive (the posterior std "
                         f"never reaches {adp_tol}), got {adp_tol}")
    fid = torch.clamp(fid, 0.0, 1.0)
    rdt, dev = fid.dtype, fid.device
    a = torch.full_like(fid, 0.5)
    b = torch.full_like(fid, 0.5)
    mean = a / (a + b)
    var = mean * (1.0 - mean) / (a + b + 1.0)
    calls = torch.zeros(fid.shape, dtype=torch.int32, device=dev)
    done = torch.sqrt(var) <= adp_tol
    batches = _adaptive_batches(draws, adp_tol)
    step = torch.arange(1, batches + 1, dtype=torch.int32, device=dev)
    k = key
    while not bool(done.all()):
        subs = []
        for _ in range(batches):
            k, ks = prng.split(k).unbind(-2)
            subs.append(ks)
        s = prng.binomial(torch.stack(subs, dim=-2), draws,
                          fid[..., None].expand(fid.shape + (batches,))
                          ).to(rdt)
        aj = a[..., None] + torch.cumsum(s, -1)
        bj = b[..., None] + torch.cumsum(draws - s, -1)
        tot = aj + bj + draws
        mj = (aj + s) / tot
        vj = mj * (1.0 - mj) / (tot + 1.0)
        # the batch after which each element's loop ends (the pass's last
        # where it runs on)
        fin = torch.sqrt(vj) <= adp_tol
        ends = fin.any(-1)
        last = torch.where(ends, fin.to(torch.int8).argmax(-1),
                           batches - 1)[..., None]
        live = ~done
        a = torch.where(live, aj.gather(-1, last)[..., 0], a)
        b = torch.where(live, bj.gather(-1, last)[..., 0], b)
        mean = torch.where(live, mj.gather(-1, last)[..., 0], mean)
        calls = torch.where(live, calls + draws * step[last[..., 0]], calls)
        done = done | ends
    return mean, calls


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
