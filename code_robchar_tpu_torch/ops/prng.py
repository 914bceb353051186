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
  ``sqrt(2) * erfinv(u)`` with ``lo = nextafter(-1, 0)``;
- ``randint``: two draws of the dtype's width from ``split(key)``, combined
  modulo the span as jax's ``_randint`` does in unsigned arithmetic;
- ``binomial``: jax's ``_binomial`` (inversion where ``count * q <= 10``,
  the BTRS rejection sampler elsewhere, the same key split orders).

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

``binomial`` takes ``log`` (and ``log1p``) from torch, which rounds
differently from XLA on about 14% of float32 inputs by one ulp.  The
words and the uniforms are the reference's; a count differs only where
such a one-ulp difference crosses a ``ceil``/``floor`` or an acceptance
bound, on a small share of elements (the tests measure it).
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



# ------------------------------------------------------------- randint

def _mul_lo32(x: torch.Tensor, y) -> torch.Tensor:
    """The low 32 bits of x * y for 0 <= x, y < 2**32, the wrapping
    product of uint32, from 16-bit halves: every int64 product stays below
    2**33, so nothing relies on how a device wraps an int64 overflow."""
    lo = (x & 0xFFFF) * (y & 0xFFFF)
    mid = ((x >> 16) * (y & 0xFFFF) + (x & 0xFFFF) * (y >> 16)) & 0xFFFF
    return (lo + (mid << 16)) & _MASK


def _mulmod(x: torch.Tensor, y: int, s: int) -> torch.Tensor:
    """(x * y) mod s for 0 <= x, y < s <= 2**32, exactly: y in 16-bit
    halves keeps every int64 product below 2**49."""
    return ((x * (y >> 16)) % s * 65536 + x * (y & 0xFFFF)) % s


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.randint`` for int32 (32-bit draws) or int64 (64-bit
    draws, the dtype jax takes with x64 on): key (..., 2) -> (..., *shape)
    in [minval, maxval).

    jax's ``_randint``: ``k1, k2 = split(key)``, a draw of the dtype's width
    from each, ``span = maxval - minval`` (1 where maxval <= minval, one
    more where maxval lies past the dtype's range), the multiplier
    ``(2**(nbits/2) mod span)**2 mod span`` and ``((hi mod span) *
    multiplier + lo mod span) mod span``, in unsigned arithmetic that wraps
    at 2**nbits.  ``minval`` and ``maxval`` are Python ints; spans above
    2**32 raise ``ValueError``."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    nbits = 32 if dtype == torch.int32 else 64
    info = torch.iinfo(dtype)
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > info.max
    lo = min(max(minval, info.min), info.max)
    hi = min(max(maxval, info.min), info.max)
    span = (hi - lo) % 2 ** nbits
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) % 2 ** nbits
    if not 0 < span <= 2 ** 32 - (nbits == 32):
        raise ValueError(f"randint: span {maxval - minval} is out of the "
                         f"range this port covers")
    ks = split(key)
    if nbits == 32:
        higher = random_bits(ks[..., 0, :], shape)
        lower = random_bits(ks[..., 1, :], shape)
        mult = ((2 ** 16 % span) ** 2 & _MASK) % span
        off = (_mul_lo32(higher % span, mult) + lower % span) & _MASK
        off = off % span
    else:
        # a 64-bit draw is (word 0) * 2**32 + word 1; its residue from the
        # two words' residues, exactly, since span <= 2**32
        m32 = 2 ** 32 % span
        mult = m32 * m32 % span

        def residue(k):
            w0, w1 = _counter_words(k, shape)
            return (_mulmod(w0 % span, m32, span) + w1 % span) % span

        off = (_mulmod(residue(ks[..., 0, :]), mult, span)
               + residue(ks[..., 1, :])) % span
    return (lo + off).to(dtype)


# ------------------------------------------------------------- binomial

#: iterations of a sampler's loop taken per pass: the key chain is walked
#: one split at a time, the uniforms of all of a pass's iterations come
#: from one threefry evaluation, and the loop's exit is read once a pass
_PASS_ITERS = 16
#: elements (keys x shape x iterations) one pass may hold
_PASS_ELEMS = 1 << 23

#: jax.random._stirling_approx_tail's table for k = 0..9
_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


def _pass_iters(numel: int) -> int:
    return max(1, min(_PASS_ITERS, _PASS_ELEMS // max(numel, 1)))


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as an IEEE division: Python's ``num / tensor`` is a
    reciprocal and a product, rounded twice."""
    return torch.div(torch.tensor(num, dtype=den.dtype, device=den.device),
                     den)


def _chain(key: torch.Tensor, width: int, steps: int):
    """``steps`` turns of a sampler loop's key split: ``subkey, key =
    split(key)`` (width 2, inversion) or ``key, subkey_0, subkey_1 =
    split(key, 3)`` (width 3, BTRS).  Returns the subkeys, (..., steps,
    width - 1, 2), and the key after the last turn."""
    carried = 1 if width == 2 else 0
    subs = []
    for _ in range(steps):
        ks = split(key, width)
        subs.append(ks[..., :1, :] if width == 2 else ks[..., 1:, :])
        key = ks[..., carried, :]
    return torch.stack(subs, dim=-3), key


def _pass_uniforms(subs: torch.Tensor, shape, dtype, lead: int):
    """Uniforms of a pass: subkeys (*lead, steps, w, 2) -> w tensors
    (*lead, *shape, steps), the iteration axis last."""
    u = uniform(subs, shape, dtype)          # (*lead, steps, w, *shape)
    return [u.select(lead + 1, j).movedim(lead, -1)
            for j in range(subs.shape[-2])]


def _inversion(key, count, q, lead: int, shape):
    """jax.random._binomial_inversion: the number of geometric waiting
    times ``ceil(log u / log1p(-q))`` whose running sum stays within
    ``count``, less one.  A done element's count never moves again (each
    waiting time is at least 1), so extra iterations change nothing."""
    dt = q.dtype
    log1mq = torch.log1p(-q)[..., None]
    num = torch.zeros_like(q)
    gsum = torch.zeros_like(q)
    # every waiting time is at least 1, so an element is done after at most
    # floor(count) + 1 iterations: a pass of that many is the whole loop
    usable = torch.where(torch.isfinite(count) & (count >= 0), count, 0.0)
    steps = min(_pass_iters(q.numel()), int(usable.max()) + 1)
    while True:
        subs, key = _chain(key, 2, steps)
        u, = _pass_uniforms(subs, shape, dt, lead)
        geom = torch.ceil(torch.log(u) / log1mq)
        # the running sum before each iteration, in the loop's order
        sums = torch.cumsum(torch.cat([gsum[..., None], geom], -1), -1)
        num = num + (sums[..., :-1] <= count[..., None]).sum(-1).to(dt)
        gsum = sums[..., -1]
        if not bool((gsum <= count).any()):
            return num - 1


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """jax.random._stirling_approx_tail, its clamp included: above 9 the
    series is taken at k = 9."""
    table = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    use_tail = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - _rdiv(1.0 / 1260, kp1sq)) / kp1sq) \
        / (k + 1)
    idx = torch.where(use_tail, torch.floor(k), 0.0).to(torch.int64)
    return torch.where(use_tail, table[idx], approx)


def _btrs(key, count, p, lead: int, shape):
    """jax.random._btrs, the transformed-rejection sampler.  Every
    iteration sets k_out where it accepts, also for elements that accepted
    before, and a batch member's loop ends at the first iteration after
    which all of its elements have accepted: the pass picks, per element,
    the last accepting iteration up to its member's end."""
    dt = p.dtype
    stddev = torch.sqrt(count * p * (1 - p))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = count * p + 0.5
    v_r = 0.92 - _rdiv(4.2, b)
    r = p / (1 - p)
    alpha = (2.83 + _rdiv(5.1, b)) * stddev
    m = torch.floor((count + 1) * p)
    tails = (_stirling_approx_tail(m) + _stirling_approx_tail(count - m))
    a, b, c, v_r, r, alpha, m, tails, n = (
        x[..., None] for x in (a, b, c, v_r, r, alpha, m, tails, count))
    lead_shape = p.shape[:lead]
    k_out = torch.full_like(p, -1.0)
    accepted = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    done = torch.zeros(lead_shape, dtype=torch.bool, device=p.device)
    steps = _pass_iters(2 * p.numel())
    it = torch.arange(steps, device=p.device)
    while True:
        subs, key = _chain(key, 3, steps)
        u, v = _pass_uniforms(subs, shape, dt, lead)
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > n)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (n - m + 1)))
              + (n + 1) * torch.log((n - m + 1) / (n - k + 1))
              + (k + 0.5) * torch.log(r * (n - k + 1) / (k + 1))
              + tails
              - _stirling_approx_tail(k)
              - _stirling_approx_tail(n - k))
        accept = accept1 | (~reject & (v <= ub))
        # the member's loop ends after the first iteration by which every
        # element has accepted at least once
        seen = accepted[..., None] | (accept.cumsum(-1) > 0)
        all_in = seen.reshape(lead_shape + (-1, steps)).all(-2)
        ends = all_in.any(-1)
        stop = torch.where(ends, all_in.to(torch.int8).argmax(-1), steps - 1)
        ran = (it <= stop[..., None]) & ~done[..., None]
        ran = ran.reshape(lead_shape + (1,) * len(shape) + (steps,))
        sel = accept & ran
        last = torch.where(sel, it, -1).amax(-1)
        pick = k.gather(-1, last.clamp_min(0)[..., None])[..., 0]
        k_out = torch.where(last >= 0, pick, k_out)
        accepted = accepted | sel.any(-1)
        done = done | ends
        if bool(done.all()):
            return k_out


def binomial(key: torch.Tensor, count, prob, shape=None,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """``jax.random.binomial``: Binomial(count, prob) draws as floats.

    key (..., 2): one key draws ``shape`` (default: count's and prob's
    broadcast shape); a batch of keys draws ``shape`` (default ``()``)
    under each key, as jax's binomial vmapped over keys, and count and prob
    broadcast to (*batch, *shape).  The arithmetic is in prob's dtype
    (float32 or float64); the result is in ``dtype`` (default prob's).

    jax's ``_binomial``: inversion where ``count * q <= 10`` (q = min(p,
    1 - p)) or the count is NaN or negative, BTRS elsewhere, both from the
    same key, and ``count - k`` where p >= 0.5; NaN for a NaN or negative
    count or a NaN or negative q, inf for an infinite count.  The loops run
    while any element of a batch member is active, with no cap."""
    prob = torch.as_tensor(prob, device=key.device)
    if not prob.is_floating_point():
        prob = prob.to(torch.float32)
    dt = prob.dtype
    dtype = dt if dtype is None else dtype
    count = torch.as_tensor(count, device=key.device).to(dt)
    lead_shape = tuple(key.shape[:-1])
    if shape is None:
        shape = () if lead_shape else torch.broadcast_shapes(count.shape,
                                                             prob.shape)
    shape = tuple(shape)
    lead = len(lead_shape)
    full = lead_shape + shape
    count = torch.broadcast_to(count, full)
    prob = torch.broadcast_to(prob, full)
    if not prob.numel():
        return torch.empty(full, dtype=dtype, device=key.device)

    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, 0.01, q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)

    # each sampler runs over every element, as in jax (the other branch's
    # elements take placeholder parameters); a branch that no element takes
    # is skipped: its draws would be discarded
    inv = torch.where(use_inversion, count, 0.0)
    n_btrs = torch.where(use_inversion, 1e4, count)
    q_btrs = torch.where(use_inversion, 0.5, q)
    samples = torch.zeros_like(q)
    if bool(use_inversion.any()):
        samples = _inversion(key, inv, q, lead, shape)
    if not bool(use_inversion.all()):
        samples = torch.where(use_inversion, samples,
                              _btrs(key, n_btrs, q_btrs, lead, shape))
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, float("nan"), samples)
    samples = torch.where(count_inf & ~invalid, float("inf"), samples)
    samples = torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                          samples, count - samples)
    return samples.to(dtype)
