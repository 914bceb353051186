"""The port's MC engine (code_robchar_tpu_torch/mc/engine.py) against the
JAX engine, the slice as a whole: an n=4 chain, 5 controllers, noises
(0, 0.05, 0.1), B=16, key(7), the same threefry draws on both sides.
mc_metric_sweep at f64 within 1e-10 on all 15 tensors; mc_fidelity_sweep
at f32 within 3e-5 (the port's plain round-robin order against JAX's
cyclic XLA path, both at the f32 floor)."""

from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.ops import prng
from code_robchar_tpu_torch.utils import build

N, C, B = 4, 5, 16
NOISES = (0.0, 0.05, 0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lattice():
    rng = np.random.default_rng(21)
    h0 = np.zeros((N, N))
    for i in range(1, N):
        h0[i - 1, i] = h0[i, i - 1] = 1.0
    ctrl = np.column_stack([rng.uniform(-5, 5, (C, N)),
                            rng.uniform(0.5, 6, C)])
    return h0, ctrl, np.asarray(NOISES)


def test_metric_sweep_f64_matches_jax(lattice, monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    h0, ctrl, noises = lattice
    want = jengine.mc_metric_sweep(jnp.asarray(h0), jnp.asarray(ctrl),
                                   jnp.asarray(noises), jax.random.key(7),
                                   B, 0, N - 1, use_pallas=False)
    got = engine.mc_metric_sweep(h0, ctrl, noises, prng.key(7), B, 0, N - 1,
                                 device="cpu")
    assert set(got) == set(want) and len(got) == 15
    for k in want:
        assert got[k].shape == (3, C) and got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-10, err_msg=k)
    assert not build.LAUNCHES           # the CPU path is the plain one


def test_fidelity_sweep_f32_matches_jax(lattice):
    h0, ctrl, noises = (x.astype(np.float32) for x in lattice)
    want = jengine.mc_fidelity_sweep(jnp.asarray(h0), jnp.asarray(ctrl),
                                     jnp.asarray(noises), jax.random.key(7),
                                     B, 0, N - 1, use_pallas=False)
    got = engine.mc_fidelity_sweep(h0, ctrl, noises, prng.key(7), B, 0,
                                   N - 1, device="cpu")
    assert got.shape == (3, C, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)


def test_characterise_fused_and_unfused_agree(lattice):
    h0, ctrl, noises = lattice
    key = prng.key(7)
    full = engine.characterise(h0, ctrl, noises, key, B, 0, N - 1,
                               device="cpu")
    fused = engine.characterise(h0, ctrl, noises, key, B, 0, N - 1,
                                return_fids=False, device="cpu")
    assert full["fids"].shape == (3, C, B) and "fids" not in fused
    assert set(full) - {"fids"} == set(fused)
    for k in fused:
        np.testing.assert_allclose(fused[k].numpy(), full[k].numpy(),
                                   rtol=0, atol=1e-14, err_msg=k)


def test_chunking_does_not_change_results(lattice):
    h0, ctrl, noises = lattice
    key = prng.key(3)
    ref = engine.mc_fidelity_sweep(h0, ctrl, noises, key, B, 0, N - 1,
                                   device="cpu")
    for chunk in (7, 16, 50):
        got = engine.mc_fidelity_sweep(h0, ctrl, noises, key, B, 0, N - 1,
                                       chunk=chunk, device="cpu")
        assert torch.equal(got, ref)
    ref_m = engine.mc_metric_sweep(h0, ctrl, noises, key, B, 0, N - 1,
                                   device="cpu")
    for chunk in (1, 48, 10_000):       # one cell, three cells, all cells
        got = engine.mc_metric_sweep(h0, ctrl, noises, key, B, 0, N - 1,
                                     chunk=chunk, device="cpu")
        for k in ref_m:
            np.testing.assert_allclose(got[k].numpy(), ref_m[k].numpy(),
                                       rtol=0, atol=1e-14, err_msg=k)


def test_jax_key_carried_across(lattice):
    """A key made in JAX and carried by its key data draws the same
    lattice as the port's own key(seed)."""
    h0, ctrl, noises = lattice
    data = np.asarray(jax.random.key_data(jax.random.key(7)))
    a = engine.mc_fidelity_sweep(h0, ctrl, noises, prng.key_from_data(data),
                                 B, 0, N - 1, device="cpu")
    b = engine.mc_fidelity_sweep(h0, ctrl, noises, prng.key(7), B, 0, N - 1,
                                 device="cpu")
    assert torch.equal(a, b)


def test_complex_h0_and_real_offdiag_match_jax(lattice):
    """A complex drift uses its real part; complex_offdiag=False is the
    real-coupling noise variant."""
    h0, ctrl, noises = lattice
    want = jengine.mc_fidelity_sweep(jnp.asarray(h0 + 0j), jnp.asarray(ctrl),
                                     jnp.asarray(noises), jax.random.key(9),
                                     B, 1, 2, complex_offdiag=False,
                                     use_pallas=False)
    got = engine.mc_fidelity_sweep(torch.as_tensor(h0 + 0j), ctrl, noises,
                                   prng.key(9), B, 1, 2,
                                   complex_offdiag=False, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
