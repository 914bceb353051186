"""Threefry-2x32 counter draws in NumPy, frozen for the benchmark's
references.

The port derives every random number of a run from explicit threefry keys
(``code_robchar_tpu_torch/ops/prng.py``, which follows ``jax.random`` with
``jax_threefry_partitionable=True``).  The references work the draws out
again from the seed with this copy of the same construction:

- ``threefry2x32``: the 20-round hash (rotations 13/15/26/6 and
  17/29/16/24, key schedule with 0x1BD11BDA), ops/prng.py:58-70;
- ``key(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF), ops/prng.py:73;
- ``fold_in(k, d)``: threefry(k, (0, d)), ops/prng.py:91;
- ``split(k, num)`` and the bits of element i of a shape: threefry(k,
  (i >> 32, i & 0xFFFFFFFF)) over the row-major flat index; a 32-bit draw
  is the XOR of the two output words, ops/prng.py:102-127;
- ``uniform32``: the float32 mantissa fill in [1, 2) shifted to [lo, hi),
  ops/prng.py:130-156;
- ``normal``: sqrt(2) * erfinv(u) on the float32 uniforms of
  [nextafter(-1, 0), 1), ops/prng.py:219-224, with SciPy's exact erfinv
  in float64 where the port takes XLA's float32 polynomial (the two part by
  at most ~1.5e-5 relative in the tails: a rounding of the program's, not
  of the reference's);
- ``uniform64`` and ``normal64``: the same under JAX's x64 construction,
  for a float64 configuration: the top 52 bits of the 64-bit draw
  (w0 << 32 | w1) filled into [1, 2), ops/prng.py:133-136, then the same
  shift and SciPy's exact erfinv in float64 (XLA's float64 polynomial
  parts from it by up to ~4e-10 relative in the tails).

Keys are uint32 arrays of shape (..., 2).  NumPy's uint32 arithmetic wraps
modulo 2**32, which is the hash's own arithmetic.
"""

from __future__ import annotations

import numpy as np
from scipy import special

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The two output words for broadcastable uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(v, dtype=_U32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=_U32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """Keys (..., 2) folded with uint32 ``data`` (broadcast)."""
    data = np.asarray(data, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    data = data.astype(_U32)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(data), data)
    return np.stack([o0, o1], axis=-1)


def _counter_words(k: np.ndarray, count: int):
    idx = np.arange(count, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    return threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """Keys (..., 2) -> (..., num, 2)."""
    b0, b1 = _counter_words(k, num)
    return np.stack([b0, b1], axis=-1)


def uniform32(k: np.ndarray, count: int, lo: float = 0.0,
              hi: float = 1.0) -> np.ndarray:
    """float32 uniforms (..., count) in [lo, hi) from keys (..., 2)."""
    b0, b1 = _counter_words(k, count)
    bits = ((b0 ^ b1) >> _U32(9)) | _U32(0x3F800000)
    unit = bits.view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return np.maximum(unit * (hi32 - lo32) + lo32, lo32)


def uniform64(k: np.ndarray, count: int, lo: float = 0.0,
              hi: float = 1.0) -> np.ndarray:
    """float64 uniforms (..., count) in [lo, hi) from keys (..., 2)."""
    b0, b1 = _counter_words(k, count)
    bits = ((b0.astype(np.uint64) << np.uint64(32) | b1) >> np.uint64(12)
            ) | np.uint64(0x3FF0000000000000)
    unit = bits.view(np.float64) - 1.0
    lo64, hi64 = np.float64(lo), np.float64(hi)
    return np.maximum(unit * (hi64 - lo64) + lo64, lo64)


def normal(k: np.ndarray, count: int) -> np.ndarray:
    """Standard normals (..., count), float64, from the float32 uniforms of
    ``jax.random.normal``'s construction."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform32(k, count, float(lo), 1.0).astype(np.float64)
    return np.sqrt(2.0) * special.erfinv(u)


def normal64(k: np.ndarray, count: int) -> np.ndarray:
    """Standard normals (..., count), float64, from the float64 uniforms of
    ``jax.random.normal``'s x64 construction."""
    lo = np.nextafter(-1.0, 0.0)
    return np.sqrt(2.0) * special.erfinv(uniform64(k, count, lo, 1.0))
