"""Transfer fidelities of the XX spin chain in plain NumPy: the references'
physics, and its controls.

    F = |<out| exp(-i T H) |in>|^2 = |sum_k V[out, k] conj(V[in, k])
                                      exp(-i T lam_k)|^2

from ``numpy.linalg.eigh`` of H in float64 (complex128 for Hermitian H).
The drift is the single-excitation XX chain: couplings 1 between
neighbours, no field (arXiv:2207.07801, Sec. II).

``precision`` names the control that a correctness check has to fail: the
same computation with every operand rounded to the precision just below the
configuration's ``dtype`` (complex parts each):

- ``"tf32"`` for a float32 configuration (TF32 off): 10 explicit mantissa
  bits, round to nearest even;
- ``"float32"`` for a float64 configuration.

The eigensolver itself runs in float64 between the roundings of its inputs
and outputs.  ``"float64"`` rounds nothing: the reference.
"""

from __future__ import annotations

import numpy as np


def tf32(x):
    """``x`` rounded to TF32, returned as float64 (complex parts each)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return tf32(x.real) + 1j * tf32(x.imag)
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + np.uint64(0xFFF) + ((bits >> np.uint64(13)) & np.uint64(1))
            ) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def f32(x):
    """``x`` rounded to float32, returned as float64 (complex parts each)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return x.astype(np.complex64).astype(np.complex128)
    return x.astype(np.float32).astype(np.float64)


#: the rounding of each precision
_ROUNDINGS = {"float64": lambda x: x, "float32": f32, "tf32": tf32}


def _round(x, precision):
    return _ROUNDINGS[precision](x)


def xx_chain(n: int) -> np.ndarray:
    """The XX chain's drift, (n, n) float64."""
    h = np.zeros((n, n))
    i = np.arange(n - 1)
    h[i, i + 1] = h[i + 1, i] = 1.0
    return h


def fidelity(h: np.ndarray, t: np.ndarray, in_site: int, out_site: int,
             precision: str = "float64") -> np.ndarray:
    """F for Hermitian (or real symmetric) h (..., n, n) and times t (...)."""
    h = _round(h, precision)
    t = _round(np.abs(t), precision)
    lam, v = np.linalg.eigh(h)
    lam, v = _round(lam, precision), _round(v, precision)
    g = _round(v[..., out_site, :] * np.conj(v[..., in_site, :]), precision)
    phase = _round(np.exp(-1j * _round(lam * t[..., None], precision)),
                   precision)
    amp = np.sum(g * phase, axis=-1)
    return np.abs(amp) ** 2


def controlled(h0: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """H0 + diag(x[:n]) for controllers xs (..., n + 1), float64."""
    n = h0.shape[-1]
    xs = np.asarray(xs, dtype=np.float64)
    return h0 + xs[..., :n, None] * np.eye(n)


def controller_fidelity(h0, xs, in_site, out_site, precision="float64"):
    """F of controllers xs (K, n + 1) (biases, then the time) on the
    noiseless drift h0."""
    xs = np.asarray(xs, dtype=np.float64)
    n = h0.shape[-1]
    return fidelity(controlled(h0, xs), xs[..., n], in_site, out_site,
                    precision)


def infidelity_and_gradient(h0, xs, in_site, out_site,
                            precision: str = "float64"):
    """(1 - F (K,), d(1 - F)/dx (K, n + 1)) at controllers xs (K, n + 1),
    analytically: with H = V diag(lam) V^T and A = <out| exp(-i t H) |in>,
    dA/dt = sum_k V[out, k] V[in, k] (-i lam_k) exp(-i t lam_k) and
    dA/db_j = sum_kl V[out, k] V[j, k] G_kl V[j, l] V[in, l], where
    G_kl = -i t exp(-i t (lam_k + lam_l) / 2) sinc(t (lam_l - lam_k) / 2)
    (the divided difference of exp(-i t lam)); dF = 2 Re(conj(A) dA).
    ``precision="tf32"`` rounds every product's operands to TF32."""
    r = (lambda x: _round(x, precision))
    xs = np.asarray(xs, dtype=np.float64)
    n = h0.shape[-1]
    t = r(np.abs(xs[:, n]))
    lam, v = np.linalg.eigh(r(controlled(h0, xs)))
    lam, v = r(lam), r(v)
    g = r(v[:, out_site, :] * v[:, in_site, :])
    phase = r(np.exp(-1j * r(lam * t[:, None])))
    amp = r(np.sum(g * phase, axis=-1))
    d_t = np.sum(g * r(-1j * lam) * phase, axis=-1)
    mid = r(0.5 * (lam[:, :, None] + lam[:, None, :]) * t[:, None, None])
    half = r(0.5 * (lam[:, None, :] - lam[:, :, None]) * t[:, None, None])
    gam = r(-1j * t[:, None, None] * np.exp(-1j * mid) * np.sinc(
        half / np.pi))
    p = r(v[:, out_site, None, :] * v)                  # (K, j, k)
    q = r(v * v[:, in_site, None, :])                   # (K, j, l)
    d_b = np.einsum("bjk,bkl,bjl->bj", p, gam, q)
    d_a = np.concatenate([d_b, d_t[:, None]], axis=1)
    grad = -2.0 * np.real(np.conj(amp)[:, None] * d_a)
    return 1.0 - np.abs(amp) ** 2, grad
