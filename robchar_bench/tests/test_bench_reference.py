"""Each reference agrees with the port at tiny sizes on the CPU; the
references themselves import nothing of the port, the tests do."""

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.ops import chain, cuda_jacobi, prng
from robchar_bench.reference import mc as ref_mc
from robchar_bench.reference import physics, threefry

SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_equal_the_port(seed):
    k = threefry.key(seed)
    assert (k.astype(np.int64) == prng.key(seed).numpy()).all()
    d = np.arange(50, dtype=np.uint32) * 7919
    got = threefry.fold_in(k, d)
    assert (got.astype(np.int64) ==
            prng.fold_in(prng.key(seed), torch.as_tensor(d.astype(np.int64)))
            .numpy()).all()
    assert (threefry.split(got, 3).astype(np.int64) ==
            prng.split(torch.as_tensor(got.astype(np.int64)), 3).numpy()).all()
    u = threefry.uniform32(got, 9)
    assert (u == prng.uniform(torch.as_tensor(got.astype(np.int64)), (9,),
                              torch.float32).numpy()).all()
    z = threefry.normal(got, 9)
    want = prng.normal(torch.as_tensor(got.astype(np.int64)), (9,),
                       torch.float32).numpy()
    # XLA's float32 erf_inv polynomial parts from the exact function by
    # up to ~1.5e-5 relative in the tails (ops/prng.py)
    assert np.all(np.abs(z - want) <= 5e-6 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_x64_draws_equal_the_port(seed):
    got = threefry.fold_in(threefry.key(seed),
                           np.arange(50, dtype=np.uint32) * 7919)
    keys = torch.as_tensor(got.astype(np.int64))
    u = threefry.uniform64(got, 9)
    assert u.dtype == np.float64
    assert (u == prng._unit_floats(keys, (9,), torch.float64).numpy()).all()
    assert (threefry.uniform64(got, 9, -3.0, 2.5) ==
            prng.uniform(keys, (9,), torch.float64, -3.0, 2.5).numpy()).all()
    z = threefry.normal64(got, 9)
    want = prng.normal(keys, (9,), torch.float64).numpy()
    # XLA's float64 erf_inv polynomial parts from the exact function by
    # up to ~4e-10 relative in the tails (ops/prng.py)
    assert np.all(np.abs(z - want) <= 1e-9 * np.abs(want))


@pytest.mark.parametrize("n,out", [(5, 2), (7, 6)])
def test_mc_reference_equals_the_port_at_float64(n, out):
    rng = np.random.default_rng(n)
    ctrl = np.column_stack([rng.uniform(-10, 10, (3, n)),
                            rng.uniform(0, 30, 3)])
    noises = np.linspace(0, 0.1, 3)
    seed, b = 2**31 + 5, 12
    got = engine.characterise(
        chain.xx_hamiltonian_real(n, dtype=torch.float64), ctrl, noises,
        prng.fold_in(prng.key(seed), 4), b, 0, out, alpha=0.05,
        device="cpu")
    assert got["fids"].dtype == torch.float64
    cells = np.array([(l, c) for l in range(3) for c in range(3)])
    rkey = threefry.fold_in(threefry.key(seed), 4)
    want = ref_mc.fidelities(rkey, n, 0, out, ctrl, noises, 3, b, cells,
                             dtype="float64")
    assert np.abs(got["fids"].numpy().reshape(-1, b) - want).max() < 1e-13
    want_m = ref_mc.metrics(want, 0.05)
    for k in want_m:
        assert np.abs(got[k].numpy().reshape(-1) - want_m[k]).max() < 1e-13, k
    # the float32 draws are other numbers altogether
    want32 = ref_mc.fidelities(rkey, n, 0, out, ctrl, noises, 3, b, cells)
    assert np.abs(want32 - want).max() > 1e-6 * want.max()


@pytest.mark.parametrize("n,out", [(5, 2), (7, 6)])
def test_mc_reference_equals_the_port(n, out):
    rng = np.random.default_rng(n)
    ctrl = np.column_stack([rng.uniform(-10, 10, (3, n)),
                            rng.uniform(0, 30, 3)]).astype(np.float32)
    noises = np.linspace(0, 0.1, 3).astype(np.float32)
    seed, b = 2**31 + 5, 12
    key = prng.fold_in(prng.key(seed), 4)
    fids = engine.mc_fidelity_sweep(
        chain.xx_hamiltonian_real(n, dtype=torch.float32), ctrl, noises, key,
        b, 0, out, device="cpu").numpy().reshape(-1, b)
    cells = np.array([(l, c) for l in range(3) for c in range(3)])
    rkey = threefry.fold_in(threefry.key(seed), 4)
    want = ref_mc.fidelities(rkey, n, 0, out, ctrl, noises, 3, b, cells)
    assert np.abs(fids - want).max() < 2e-5
    got_m = engine.metric_tensors(torch.as_tensor(fids, dtype=torch.float64),
                                  0.05)
    want_m = ref_mc.metrics(fids.astype(np.float64), 0.05)
    assert sorted(want_m) == sorted(got_m)
    for k in want_m:
        assert np.abs(got_m[k].numpy() - want_m[k]).max() < 1e-12, k


@pytest.mark.parametrize("n,out", [(5, 2), (7, 6)])
def test_zoo_reference_equals_the_port(n, out):
    rng = np.random.default_rng(n + 1)
    xs = np.column_stack([rng.uniform(-2, 2, (16, n)), rng.uniform(0, 8, 16)])
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float64)
    want = objectives.fidelity_batch(h0, torch.as_tensor(xs), 0, out).numpy()
    got = physics.controller_fidelity(physics.xx_chain(n), xs, 0, out)
    assert np.abs(got - want).max() < 1e-10
    err, grad = cuda_jacobi.infidelity_and_gradient_sym(
        h0, torch.as_tensor(xs), 0, out)
    want_e, want_g = physics.infidelity_and_gradient(physics.xx_chain(n), xs,
                                                     0, out)
    assert np.abs(err.numpy() - want_e).max() < 1e-10
    assert np.abs(grad.numpy() - want_g).max() < 1e-9
    # and the analytic gradient is the central difference's
    step, eye = 1e-6, np.eye(n + 1) * 1e-6
    fd = -(physics.controller_fidelity(physics.xx_chain(n),
                                       xs[:, None, :] + eye, 0, out)
           - physics.controller_fidelity(physics.xx_chain(n),
                                         xs[:, None, :] - eye, 0, out)) \
        / (2 * step)
    assert np.abs(fd - want_g).max() < 1e-7
    # the TF32 control parts from it by far more than float32 would
    tf_e, tf_g = physics.infidelity_and_gradient(physics.xx_chain(n), xs, 0,
                                                 out, precision="tf32")
    assert np.abs(tf_g - want_g).max() > 1e-4 * np.abs(want_g).max()


def test_float32_control_rounds_each_part():
    x = np.array([1.0 + 2**-30, -3.3, 1e-3]) + 1j * np.array([0.1, 2.0, -7.7])
    got = physics.f32(x)
    assert got.dtype == np.complex128
    assert (got.real == x.real.astype(np.float32)).all()
    assert (got.imag == x.imag.astype(np.float32)).all()
    assert (physics.f32(x.real) == x.real.astype(np.float32)).all()
    h = physics.controlled(physics.xx_chain(5),
                           np.array([[0.3, -1.1, 2.2, 0.7, -0.4, 9.1]]))
    f64 = physics.fidelity(h, np.array([9.1]), 0, 4)
    f32 = physics.fidelity(h, np.array([9.1]), 0, 4, "float32")
    tf = physics.fidelity(h, np.array([9.1]), 0, 4, "tf32")
    assert 0 < abs(f32 - f64) < abs(tf - f64)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -3.3])
    got = physics.tf32(x)
    assert list(got[:4]) == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10]
    assert abs(got[4] + 3.3) <= 3.3 * 2**-11
    m = np.frexp(got)[0] * 2**11
    assert np.all(m == np.round(m))
