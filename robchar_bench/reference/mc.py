"""The Monte-Carlo robustness characterisation in plain NumPy: the
reference of the ``mc`` cells.

For lattice element (noise level l, controller c, bootstrap rep b) of a
sweep over L levels, C controllers and B reps, with the sweep's key K:

- its key is fold_in(K, (l * C + c) * B + b), split into three: the
  diagonal, the real and the imaginary nearest-neighbour couplings;
- each draws n standard normals, scaled by sigma_l (the couplings take the
  first n - 1);
- H = H0 + diag(d + x_c[:n]), H[i, i-1] = 1 + r_i + i m_i, H[i-1, i] its
  conjugate (the structured Gaussian noise of the paper's noise model,
  complex couplings);
- F = |<out| exp(-i |x_c[n]| H) |in>|^2 (reference/physics.py);
- per (l, c), over the B fidelities, five metrics and their DKW bands:
  the RIM mean(1 - F), -Q(0.95), -Q(0.98) (Q: the share of F >= the
  threshold), the population std and -min(F); "upper" is computed from
  clip(F - eps, 0, 1) and "lower" from clip(F + eps, 0, 1), eps =
  sqrt(log(2 / alpha) / (2 B)) (the .mcm schema's naming).

Every draw is worked out again from the key with reference/threefry.py,
in the configuration's dtype: a float32 configuration's normals come from
JAX's 32-bit uniforms, a float64 one's from its x64 uniforms.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from robchar_bench.reference import physics, threefry

RIM = r"$W(.,\delta(x-1))$"
_BASE = {
    RIM: lambda f: np.mean(1.0 - f, axis=-1),
    "Q th. 0.95": lambda f: -np.mean(f >= 0.95, axis=-1),
    "Q th. 0.98": lambda f: -np.mean(f >= 0.98, axis=-1),
    "std": lambda f: np.std(f, axis=-1),
    "worst case fid": lambda f: -np.min(f, axis=-1),
}


def metric_names():
    return [name + band for name in _BASE for band in ("", " upper", " lower")]


def fidelities(key, n, in_site, out_site, controllers, noises, num_c,
               bootreps, cells, precision="float64",
               dtype="float32") -> np.ndarray:
    """Fidelities (len(cells), bootreps) of the lattice cells ``cells``
    ((K, 2) of (l, c)) of a sweep keyed by ``key`` (uint32 (2,)) over
    ``num_c`` controllers, whose draws are of ``dtype``: "float32" (JAX's
    32-bit uniforms, sigma rounded to float32) or "float64" (its x64
    uniforms, sigma as given).  ``precision`` as physics.fidelity's."""
    cells = np.asarray(cells, dtype=np.int64)
    l_idx, c_idx = cells[:, 0], cells[:, 1]
    gids = ((l_idx * num_c + c_idx)[:, None] * bootreps
            + np.arange(bootreps)[None, :])
    keys = threefry.fold_in(key, gids)                  # (K, B, 2)
    normal = {"float32": threefry.normal, "float64": threefry.normal64}[dtype]
    z = normal(threefry.split(keys, 3), n)              # (K, B, 3, n)
    sigma = np.asarray(noises, dtype=dtype).astype(np.float64)[l_idx]
    z = z * sigma[:, None, None, None]
    x = np.asarray(controllers, dtype=np.float64)[c_idx]  # (K, n + 1)
    h = np.zeros(z.shape[:2] + (n, n), dtype=np.complex128)
    i = np.arange(n)
    h[..., i, i] = z[..., 0, :] + x[:, None, :n]
    off = 1.0 + z[..., 1, :n - 1] + 1j * z[..., 2, :n - 1]
    h[..., i[1:], i[:-1]] = off
    h[..., i[:-1], i[1:]] = np.conj(off)
    t = np.broadcast_to(x[:, None, n], h.shape[:2])
    return physics.fidelity(h, t, in_site, out_site, precision)


def metrics(fids: np.ndarray, alpha: float) -> Dict[str, np.ndarray]:
    """The 15 metric values of each row of ``fids`` (K, B)."""
    eps = math.sqrt(math.log(2.0 / alpha) / (2.0 * fids.shape[-1]))
    bands = {"": fids, " upper": np.clip(fids - eps, 0.0, 1.0),
             " lower": np.clip(fids + eps, 0.0, 1.0)}
    return {name + band: fn(f) for name, fn in _BASE.items()
            for band, f in bands.items()}
