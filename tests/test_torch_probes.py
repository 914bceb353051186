"""The port's measurement probes (code_robchar_tpu_torch/ops/probes.py, the
plain versions of csrc/alu_probe.cu and csrc/tanh_probe.cu) against the
Pallas kernels they replace, run in interpret mode on the CPU.

The two Pallas kernels cannot be imported: ``make_probe`` is a closure
inside ``main()`` of artifacts/perf/roofline.py, and
artifacts/perf/tanh_microbench.py runs its benchmarks at import.  Their
bodies are copied below (roofline.py:257-267 with the call of :270-276,
tanh_microbench.py:27-30 with the rational tanh of :52-66) and run through
``pl.pallas_call(..., interpret=True)`` with the same specs.

The port takes every multiply and add with its own rounding (the kernels'
``__fmul_rn`` / ``__fadd_rn``).  XLA:CPU, which runs the interpreted
bodies, does not: it contracts ``x * m + c`` into one fused multiply-add
and folds ``(x * 1.0001) * 0.999`` into one multiply by the rounded
product of the constants.  So each case holds

- the plain version against the interpreted kernel: bit-equal for the ALU
  probe on the reference's input (its products are ~1e-3 of the addend, so
  one rounding or two give the same sum), within K * 2^-23 (relative, op
  mul) or K * 2^-24 (absolute, tanh and rational: every step moves a value
  below 1 by at most an ulp or two and the chain damps it by 0.999) for the
  tanh probe's ops;
- a model of what XLA compiles (the same steps with a correctly rounded
  fused multiply-add, or the folded constant) bit-equal to the interpreted
  kernel, which shows that the copied bodies are the reference's and that
  the rewrite is the whole difference; for the ALU probe also on an input
  whose multipliers are near 1, where one rounding and two differ.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from code_robchar_tpu_torch.ops import probes
from code_robchar_tpu_torch.utils import build

N, TILE, LANES = 7, 128, 256
SHAPE = (16, 128)
K = 64


# the Pallas bodies, copied from the reference --------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_probe(streams, k):
    """roofline.py:257-276, interpret=True."""
    def kernel(x_in, y_out, scr):
        scr[:, :] = x_in[:, :]
        xs = [scr[i, :] for i in range(streams)]
        m = scr[streams, :]
        c = scr[streams + 1, :]
        for _ in range(k // streams):
            xs = [x * m + c for x in xs]
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        y_out[0, :] = acc

    def run(x):
        b = x.shape[-1]
        return pl.pallas_call(
            kernel, grid=(b // TILE,),
            in_specs=[pl.BlockSpec((N * N, TILE), lambda i: (0, i))],
            out_specs=pl.BlockSpec((1, TILE), lambda i: (0, i)),
            out_shape=jax.ShapeDtypeStruct((1, b), x.dtype),
            scratch_shapes=[pltpu.VMEM((N * N, TILE), x.dtype)],
            interpret=True,
        )(x)
    return run


def make_kernel(op, k):
    """tanh_microbench.py:26-31, interpret=True."""
    def kernel(x_ref, o_ref):
        def body(i, acc):
            return op(acc) * 0.999
        o_ref[...] = jax.lax.fori_loop(0, k, body, x_ref[...])
    return pl.pallas_call(kernel, interpret=True,
                          out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.float32))


def rational_tanh(x):
    """tanh_microbench.py:52-66."""
    x = jnp.clip(x, -7.99881172180175781, 7.99881172180175781)
    x2 = x * x
    a = x2 * -2.76076847742355e-16 + 2.00018790482477e-13
    a = x2 * a + -8.60467152213735e-11
    a = x2 * a + 5.12229709037114e-08
    a = x2 * a + 1.48572235717979e-05
    a = x2 * a + 6.37261928875436e-04
    a = x2 * a + 4.89352455891786e-03
    p = x * a
    b = x2 * 1.19825839466702e-06 + 1.18534705686654e-04
    b = x2 * b + 2.26843463243900e-03
    q = x2 * b + 4.89352518554385e-03
    return p / q


JAX_OPS = {"mul": lambda x: x * 1.0001, "tanh": jnp.tanh,
           "rational": rational_tanh}


# a model of XLA:CPU's rewrites --------------------------------------------


def _fma(a, b, c):
    """Correctly rounded float32 a * b + c: the product is exact in
    float64, the sum is rounded to odd there (the error from TwoSum), and
    rounding that to float32 rounds once."""
    a, b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b))
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float32).double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def _alu_fused(x, streams, k):
    xs = [x[s] for s in range(streams)]
    m, c = x[streams], x[streams + 1]
    for _ in range(k // streams):
        xs = [_fma(v, m, c) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc[None]


def _rational_fused(x):
    c = [np.float32(v) for v in probes._NUM + probes._DEN]
    x = torch.clamp(x, -probes._CLAMP, probes._CLAMP)
    x2 = x * x
    a = _fma(x2, c[0], c[1])
    for coef in c[2:7]:
        a = _fma(x2, a, coef)
    b = _fma(x2, c[7], c[8])
    for coef in c[9:]:
        b = _fma(x2, b, coef)
    return (x * a) / b


def _xla_model(x, op, k):
    """The tanh probe's chain as XLA:CPU compiles it (None for tanh)."""
    if op == "tanh":
        return None
    folded = float(np.float32(1.0001) * np.float32(0.999))
    for _ in range(k):
        x = x * folded if op == "mul" else _rational_fused(x) * 0.999
    return x


# the tests ------------------------------------------------------------------


@pytest.mark.parametrize("streams", [1, 4, 8])
def test_alu_probe_plain_matches_pallas(streams):
    x = probes.reference_alu_input(LANES)
    want = np.asarray(make_probe(streams, K)(jnp.asarray(x)))
    got = probes.alu_probe(torch.as_tensor(x), streams, K)
    assert got.shape == (1, LANES) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # multipliers near 1: one rounding and two part; XLA's is the fused one
    rng = np.random.default_rng(streams)
    y = x.copy()
    y[streams] = rng.uniform(0.9, 1.1, LANES)
    y[streams + 1] = rng.normal(size=LANES)
    want = np.asarray(make_probe(streams, K)(jnp.asarray(y)))
    fused = _alu_fused(torch.as_tensor(y), streams, K).numpy()
    np.testing.assert_array_equal(fused, want)
    plain = probes.alu_probe(torch.as_tensor(y), streams, K).numpy()
    assert not np.array_equal(plain, want)
    np.testing.assert_allclose(plain, want, rtol=K * 2.0 ** -23,
                               atol=K * 2.0 ** -23)


@pytest.mark.parametrize("op", ["mul", "tanh", "rational"])
def test_tanh_probe_plain_matches_pallas(op):
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(make_kernel(JAX_OPS[op], K)(jnp.asarray(x)))
    got = probes.tanh_probe(torch.as_tensor(x), op, K).numpy()
    assert got.shape == SHAPE
    if op == "mul":
        np.testing.assert_allclose(got, want, rtol=K * 2.0 ** -23, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=K * 2.0 ** -24)
    model = _xla_model(torch.as_tensor(x), op, K)
    if model is not None:
        np.testing.assert_array_equal(model.numpy(), want)


def test_probe_wrappers_check_their_inputs():
    x = torch.as_tensor(probes.reference_alu_input(128))
    with pytest.raises(ValueError):
        probes.alu_probe(x, 3, 8)
    with pytest.raises(ValueError):
        probes.alu_probe(x[:4], 4, 8)
    with pytest.raises(ValueError):
        probes.tanh_probe(x, "exp", 8)
    assert build.LAUNCHES["alu_probe"] == build.LAUNCHES["tanh_probe"] == 0
    assert probes.alu_ops(1 << 19, 4096) == 2.0 * (1 << 19) * 4096
    assert probes.tanh_ops(65536, "rational", 8192) == 65536 * 8192 * 24.0
