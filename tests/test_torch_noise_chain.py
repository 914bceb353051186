"""The port's chain Hamiltonians and structured noise
(code_robchar_tpu_torch/ops/{chain,noise}.py) against the JAX package:
drifts exactly equal; perturbations and the lanes-layout assembly of
mc/engine._chunk_kernel_lanes equal at f64 to 1e-14 under the same key."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu.ops import chain as jchain
from code_robchar_tpu.ops import noise as jnoise
from code_robchar_tpu_torch.ops import chain, noise, prng


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("topo", ["chain", "ring"])
@pytest.mark.parametrize("heisenberg", [False, True])
@pytest.mark.parametrize("n", [3, 6])
def test_xx_hamiltonian_exact(topo, heisenberg, n):
    want = np.asarray(jchain.xx_hamiltonian(n, topo, heisenberg,
                                            dtype=jnp.complex128))
    got = chain.xx_hamiltonian(n, topo, heisenberg, dtype=torch.complex128)
    np.testing.assert_array_equal(got.numpy(), want)
    want_r = np.asarray(jchain.xx_hamiltonian_real(n, topo, heisenberg,
                                                   dtype=jnp.float64))
    got_r = chain.xx_hamiltonian_real(n, topo, heisenberg,
                                      dtype=torch.float64)
    assert got_r.dtype == torch.float64
    np.testing.assert_array_equal(got_r.numpy(), want_r)


def test_chain_helpers_exact():
    n = 5
    with pytest.raises(ValueError):
        chain.xx_hamiltonian(n, topo="star")
    np.testing.assert_array_equal(
        chain.basis_state(n, 2, dtype=torch.complex128).numpy(),
        np.asarray(jchain.basis_state(n, 2, dtype=jnp.complex128)))
    np.testing.assert_array_equal(
        chain.control_projectors(n, dtype=torch.float64).numpy(),
        np.asarray(jchain.control_projectors(n, dtype=jnp.float64)))
    h = chain.xx_hamiltonian(n, dtype=torch.complex128)
    x = np.linspace(-1.0, 2.0, n)
    np.testing.assert_array_equal(
        chain.add_bias(h, torch.as_tensor(x)).numpy(),
        np.asarray(jchain.add_bias(jnp.asarray(h.numpy()), jnp.asarray(x))))


@pytest.mark.parametrize("complex_offdiag", [True, False])
def test_structured_perturbation_matches_jax(complex_offdiag):
    n, scale = 5, 0.07
    jkeys = jax.random.split(jax.random.key(11), 9)
    want = np.asarray(jax.vmap(lambda k: jnoise.structured_perturbation(
        k, n, scale, complex_offdiag=complex_offdiag,
        dtype=jnp.complex128))(jkeys))
    tkeys = prng.key_from_data(jax.random.key_data(jkeys))
    got = noise.structured_perturbation(tkeys, n, scale,
                                        complex_offdiag=complex_offdiag,
                                        dtype=torch.complex128)
    assert got.shape == (9, n, n) and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    # one key, no batch
    one = noise.structured_perturbation(tkeys[3], n, scale,
                                        complex_offdiag=complex_offdiag,
                                        dtype=torch.complex128)
    np.testing.assert_allclose(one.numpy(), want[3], rtol=0, atol=1e-14)


@pytest.mark.parametrize("complex_offdiag", [True, False])
def test_structured_perturbation_parts_matches_jax(complex_offdiag):
    n = 6
    jkeys = jax.random.split(jax.random.key(2), 7)
    scales = np.linspace(0.01, 0.1, 7)
    jzr, jzi = jax.vmap(lambda k, s: jnoise.structured_perturbation_parts(
        k, n, s, complex_offdiag=complex_offdiag, dtype=jnp.float64))(
            jkeys, jnp.asarray(scales))
    tkeys = prng.key_from_data(jax.random.key_data(jkeys))
    zr, zi = noise.structured_perturbation_parts(
        tkeys, n, torch.as_tensor(scales), complex_offdiag=complex_offdiag,
        dtype=torch.float64)
    np.testing.assert_allclose(zr.numpy(), np.asarray(jzr), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(zi.numpy(), np.asarray(jzi), rtol=0,
                               atol=1e-14)
    # the parts are the complex form split (same draws per key)
    z = noise.structured_perturbation(tkeys, n, torch.as_tensor(scales),
                                      complex_offdiag=complex_offdiag,
                                      dtype=torch.complex128)
    np.testing.assert_array_equal(z.real.numpy(), zr.numpy())
    np.testing.assert_array_equal(z.imag.numpy(), zi.numpy())


@pytest.mark.parametrize("complex_offdiag", [True, False])
def test_assemble_lanes_matches_jax_engine(monkeypatch, rng,
                                           complex_offdiag):
    """The JAX assembly is the body of engine._chunk_kernel_lanes: capture
    the (ar, ai, t) it hands to realform.fidelity_herm_lanes."""
    n, b = 5, 12
    h0 = np.array(jchain.xx_hamiltonian_real(n, dtype=jnp.float64))
    xs = np.column_stack([rng.uniform(-3, 3, (b, n)), rng.uniform(-4, 4, b)])
    scales = rng.uniform(0.0, 0.1, b)
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(4), jnp.arange(b, dtype=jnp.uint32))
    seen = {}

    def capture(ar, ai, t, in_spin, out_spin):
        seen.update(ar=np.asarray(ar), ai=np.asarray(ai), t=np.asarray(t))
        return jnp.zeros(ar.shape[-1], ar.dtype)

    monkeypatch.setattr(jengine.realform, "fidelity_herm_lanes", capture)
    jengine._chunk_kernel_lanes(jnp.asarray(h0), jnp.asarray(xs),
                                jnp.asarray(scales), jkeys, 0, n - 1,
                                complex_offdiag)
    ar, ai, t = noise.assemble_lanes(
        torch.as_tensor(h0), torch.as_tensor(xs), torch.as_tensor(scales),
        prng.key_from_data(jax.random.key_data(jkeys)), complex_offdiag)
    assert ar.shape == ai.shape == (n, n, b) and t.shape == (b,)
    np.testing.assert_allclose(ar.numpy(), seen["ar"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(ai.numpy(), seen["ai"], rtol=0, atol=1e-14)
    np.testing.assert_array_equal(t.numpy(), seen["t"])
    assert np.all(t.numpy() >= 0)
