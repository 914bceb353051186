"""Counter-based threefry2x32 in torch that reproduces ``jax.random``.

The JAX engine derives every lattice element's noise from
``fold_in(key, gid)`` and three split keys (mc/engine._chunk_kernel_lanes).
Reproducing those words bit for bit lets the port's sweep be held against
the reference element by element, and lets the bench checksum be compared
across frameworks.  Semantics are those of jax's default threefry2x32
implementation with ``jax_threefry_partitionable=True``:

- ``threefry2x32``: the 20-round Threefry-2x32 hash (rotations
  13/15/26/6 and 17/29/16/24, key schedule with 0x1BD11BDA);
- ``key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(k, d)``: ``threefry(k, (0, d))``;
- ``split(k, num)`` and the random bits of element ``i`` of a shape:
  ``threefry(k, (i >> 32, i & 0xFFFFFFFF))`` over the row-major flat index;
  a 32-bit draw is the XOR of the two output words, a 64-bit draw their
  concatenation (high word first);
- ``uniform``/``normal``: mantissa fill in [1, 2), shift to [lo, hi), then
  ``sqrt(2) * erfinv(u)`` with ``lo = nextafter(-1, 0)``.

A key is a tensor of dtype int64 and shape ``(..., 2)`` holding the two
uint32 words; leading dimensions are a batch of keys (the counterpart of
``vmap`` over keys).  Words live in int64 with ``& 0xFFFFFFFF`` masking
because torch lacks shift and add for uint32.

``erfinv`` is the polynomial XLA lowers ``erf_inv`` to (M. Giles,
"Approximating the erfinv function", single- and double-precision
variants), not ``torch.erfinv``: XLA's is less accurate (up to 1.5e-5 at
float32 and 4e-10 at float64 in the tails), and the draws must follow
the reference, not the exact function.  What remains is the rounding of
``log1p``, about one ulp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 word tensors;
    returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """Counterpart of ``jax.random.key(seed)`` for an integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device)


def key_from_data(data, device=None) -> torch.Tensor:
    """A key (or batch of keys) from ``jax.random.key_data(k)``: a uint32
    array of shape (..., 2)."""
    data = np.asarray(data)
    if data.dtype != np.uint32 or data.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 key data of shape (..., 2), "
                         f"got {data.dtype} {data.shape}")
    return torch.as_tensor(data.astype(np.int64), device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over broadcast batches: key (..., 2) and
    uint32 ``data`` (int or int tensor) -> keys of the broadcast shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) \
        & _MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def _counter_words(key: torch.Tensor, shape):
    """Both threefry words for every element of ``shape`` under every key
    of the batch: each (..., *shape)."""
    shape = tuple(shape)
    lead = key.shape[:-1]
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    view = lead + (1,) * len(shape)
    return threefry2x32(key[..., 0].reshape(view), key[..., 1].reshape(view),
                        idx >> 32, idx & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    b0, b1 = _counter_words(key, (num,))
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (uint32): key (..., 2) -> int64 (..., *shape)
    in [0, 2**32)."""
    b0, b1 = _counter_words(key, shape)
    return b0 ^ b1


def _unit_floats(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Floats in [0, 1) from the mantissa-fill construction of
    jax.random._uniform: the top mantissa bits of a 32-bit draw (float32)
    or of the 64-bit draw (high word, low word) (float64), exponent 0."""
    if dtype == torch.float32:
        fb = (random_bits(key, shape) >> 9) | 0x3F800000
        return fb.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        b0, b1 = _counter_words(key, shape)
        fb = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return fb.view(torch.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def uniform(key: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform``: key (..., 2) -> (..., *shape) in
    [minval, maxval)."""
    # bounds and their difference rounded to ``dtype`` on the host, as
    # jax computes them; as Python scalars they cost no host-device copy
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = npdt(minval), npdt(maxval)
    floats = _unit_floats(key, shape, dtype)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


#: Horner coefficients (highest order first) of XLA's erf_inv, per branch:
#: float32 for w = -log1p(-x^2) < 5 and >= 5; float64 for w < 6.25,
#: < 16 and >= 16.
_ERFINV32 = (
    (5.0, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
           -4.39150654e-06, 0.00021858087, -0.00125372503,
           -0.00417768164, 0.246640727, 1.50140941)),
    (None, (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613,
            0.00943887047, 1.00167406, 2.83297682)),
)
_ERFINV64 = (
    (6.25, (-3.6444120640178196996e-21, -1.685059138182016589e-19,
            1.2858480715256400167e-18, 1.115787767802518096e-17,
            -1.333171662854620906e-16, 2.0972767875968561637e-17,
            6.6376381343583238325e-15, -4.0545662729752068639e-14,
            -8.1519341976054721522e-14, 2.6335093153082322977e-12,
            -1.2975133253453532498e-11, -5.4154120542946279317e-11,
            1.051212273321532285e-09, -4.1126339803469836976e-09,
            -2.9070369957882005086e-08, 4.2347877827932403518e-07,
            -1.3654692000834678645e-06, -1.3882523362786468719e-05,
            0.0001867342080340571352, -0.00074070253416626697512,
            -0.0060336708714301490533, 0.24015818242558961693,
            1.6536545626831027356)),
    (16.0, (2.2137376921775787049e-09, 9.0756561938885390979e-08,
            -2.7517406297064545428e-07, 1.8239629214389227755e-08,
            1.5027403968909827627e-06, -4.013867526981545969e-06,
            2.9234449089955446044e-06, 1.2475304481671778723e-05,
            -4.7318229009055733981e-05, 6.8284851459573175448e-05,
            2.4031110387097893999e-05, -0.0003550375203628474796,
            0.00095328937973738049703, -0.0016882755560235047313,
            0.0024914420961078508066, -0.0037512085075692412107,
            0.005370914553590063617, 1.0052589676941592334,
            3.0838856104922207635)),
    (None, (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
            1.5076572693500548083e-09, -3.7894654401267369937e-09,
            7.6157012080783393804e-09, -1.4960026627149240478e-08,
            2.9147953450901080826e-08, -6.7711997758452339498e-08,
            2.2900482228026654717e-07, -9.9298272942317002539e-07,
            4.5260625972231537039e-06, -1.9681778105531670567e-05,
            7.5995277030017761139e-05, -0.00021503011930044477347,
            -0.00013871931833623122026, 1.0103004648645343977,
            4.8499064014085844221)),
)
#: the shift of w (or of sqrt(w)) in each branch
_ERFINV_SHIFT32 = (2.5, 3.0)
_ERFINV_SHIFT64 = (3.125, 3.25, 5.0)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv on x in (-1, 1): a branch-wise polynomial in
    w - shift (first branch) or sqrt(w) - shift (the others)."""
    if x.dtype == torch.float32:
        branches, shifts = _ERFINV32, _ERFINV_SHIFT32
    else:
        branches, shifts = _ERFINV64, _ERFINV_SHIFT64
    w = -torch.log1p(-x * x)
    sw = torch.sqrt(w)
    out = None
    for i in reversed(range(len(branches))):
        bound, coefs = branches[i]
        z = (w if i == 0 else sw) - shifts[i]
        p = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            p = c + p * z
        out = p if out is None else torch.where(w < bound, p, out)
    return out * x


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` (real dtypes): key (..., 2) -> (..., *shape)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(npdt(-1.0), npdt(0.0))
    u = uniform(key, shape, dtype, float(lo), 1.0)
    return float(npdt(np.sqrt(2))) * _erfinv(u)
