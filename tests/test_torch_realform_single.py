"""The port's single-matrix Jacobi functions (code_robchar_tpu_torch/ops/
realform.py: ``jacobi_eigh_herm``, ``fidelity_sym``, ``fidelity_herm``,
``split_hermitian``, in the JAX package's cyclic order) and the gradient
half of ops/propagate.py (``infidelity_and_gradient``, ``overlap_ss``,
``_gamma_matrix``, the complex Daleckii-Krein oracle) against the JAX
package, on the CPU at float64 with the same numpy-seeded inputs: within
1e-10 (the repo's parity bar); the eigenvectors compared through
gauge-free quantities (the projector rows that fidelities read, and
V diag(lam) V^H against the input)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_robchar_tpu.ops import propagate as jprop, realform as jrf
from code_robchar_tpu_torch import ops
from code_robchar_tpu_torch.ops import propagate, realform

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _herm(rng, lead, n):
    a = rng.normal(size=lead + (n, n)) + 1j * rng.normal(size=lead + (n, n))
    return (a + np.conj(np.swapaxes(a, -1, -2))) / 2


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("n,lead", [(4, (2, 3)), (6, ())])
def test_jacobi_eigh_herm_matches_jax(n, lead):
    rng = np.random.default_rng(n)
    h = _herm(rng, lead, n)
    ar, ai = h.real, h.imag
    jl, jvr, jvi = jrf.jacobi_eigh_herm(jnp.asarray(ar), jnp.asarray(ai))
    lam, vr, vi = realform.jacobi_eigh_herm(_t(ar), _t(ai))
    assert lam.shape == lead + (n,) and vr.shape == lead + (n, n)
    _close(lam, jl)
    v = (vr + 1j * vi).numpy()
    jv = np.asarray(jvr) + 1j * np.asarray(jvi)
    # eigenvectors are defined up to a phase: compare |V|^2 and the
    # reconstruction
    _close(np.abs(v) ** 2, np.abs(jv) ** 2)
    rebuilt = v @ (lam.numpy()[..., None] * np.conj(np.swapaxes(v, -1, -2)))
    _close(rebuilt, h)
    assert torch.equal(lam, torch.sort(lam, dim=-1).values)


@pytest.mark.parametrize("n,io", [(4, (0, 3)), (5, (1, 2))])
def test_fidelity_sym_and_herm_match_jax(n, io):
    rng = np.random.default_rng(10 + n)
    lead = (5,)
    h = _herm(rng, lead, n)
    hs = h.real
    t = rng.uniform(0.5, 8.0, lead)
    want = jrf.fidelity_sym(jnp.asarray(hs), jnp.asarray(t), *io)
    _close(realform.fidelity_sym(_t(hs), _t(t), *io), want)
    _close(ops.fidelity_sym(_t(hs), _t(t), *io), want)
    _close(realform.fidelity_sym(_t(hs), _t(t), *io,
                                 eigh_sym=realform.jacobi_eigh_sym), want)
    want = jrf.fidelity_herm(jnp.asarray(h.real), jnp.asarray(h.imag),
                             jnp.asarray(t), *io)
    got = realform.fidelity_herm(_t(h.real), _t(h.imag), _t(t), *io)
    _close(got, want)
    _close(ops.fidelity_herm(_t(h.real), _t(h.imag), _t(t), *io), want)
    _close(realform.fidelity_herm(_t(h.real), _t(h.imag), _t(t), *io,
                                  eigh_herm=realform.jacobi_eigh_herm), want)
    # the complex eigh's fidelity of the same Hamiltonians
    _close(got, propagate.transfer_fidelity(_t(h), _t(t), *io))
    # a scalar time broadcasts
    _close(realform.fidelity_sym(_t(hs), 2.5, *io),
           jrf.fidelity_sym(jnp.asarray(hs), jnp.asarray(2.5), *io))


def test_split_hermitian_matches_jax():
    rng = np.random.default_rng(4)
    h = _herm(rng, (3,), 5)
    jr, ji = jrf.split_hermitian(jnp.asarray(h))
    pr, pi = realform.split_hermitian(_t(h))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    jr, ji = jrf.split_hermitian(jnp.asarray(h.real))
    pr, pi = realform.split_hermitian(_t(h.real))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pr.dtype == torch.float64 and float(pi.abs().max()) == 0.0


def _controllers(rng, lead, n, tmax=8.0):
    return np.concatenate([rng.uniform(-3, 3, lead + (n,)),
                           rng.uniform(-tmax, tmax, lead + (1,))], -1)


@pytest.mark.parametrize("n", [4, 7])
def test_infidelity_and_gradient_matches_jax(n):
    rng = np.random.default_rng(20 + n)
    lead = (6,)
    h0 = _herm(rng, lead, n)
    x = _controllers(rng, lead, n)
    je, jg = jprop.infidelity_and_gradient(jnp.asarray(h0), jnp.asarray(x),
                                           0, n - 1)
    err, grad = propagate.infidelity_and_gradient(_t(h0), _t(x), 0, n - 1)
    assert grad.shape == lead + (n + 1,)
    _close(err, je)
    _close(grad, jg)
    _close(ops.infidelity_and_gradient(_t(h0), _t(x), 0, n - 1)[1], jg)
    # against central differences of the port's own fidelity
    eps = 1e-6
    for i in range(n + 1):
        dx = np.zeros(n + 1)
        dx[i] = eps
        fp = propagate.fidelity_from_controller(_t(h0), _t(x + dx), 0, n - 1)
        fm = propagate.fidelity_from_controller(_t(h0), _t(x - dx), 0, n - 1)
        fd = -(fp - fm) / (2 * eps)
        if i == n:       # the gradient is w.r.t. T = |x[n]| (no sign term)
            fd = fd * _t(np.sign(x[..., n]))
        _close(grad[..., i], fd, atol=1e-7)


def test_gradient_on_the_degenerate_ring_and_real_path():
    """The ring's exactly degenerate spectrum at zero bias, where the
    divided differences reach their limit; and the real symmetric path's
    gradient (realform.infidelity_and_gradient_sym) against this complex
    oracle."""
    from code_robchar_tpu.ops import chain as jchain

    n = 6
    ring = np.asarray(jchain.xx_hamiltonian(n, topo="ring"))
    xs = np.zeros((3, n + 1))
    xs[:, n] = [0.7, 2.0, 5.0]
    xs[1, :n] = 1e-4
    je, jg = jprop.infidelity_and_gradient(jnp.asarray(ring),
                                           jnp.asarray(xs), 0, 3)
    err, grad = propagate.infidelity_and_gradient(_t(ring), _t(xs), 0, 3)
    _close(err, je)
    _close(grad, jg)
    se, sg = realform.infidelity_and_gradient_sym(_t(ring.real), _t(xs), 0,
                                                  3)
    _close(se, err)
    _close(sg, grad, atol=1e-9)


def test_gamma_matrix_and_sinc_match_jax():
    rng = np.random.default_rng(9)
    lam = np.sort(rng.normal(size=(4, 6)), -1)
    lam[0, 1] = lam[0, 0]                            # a degeneracy
    lam[1, 2] = lam[1, 1] + 1e-9                     # a near one
    t = rng.uniform(0.1, 9.0, 4)
    _close(propagate._gamma_matrix(_t(lam), _t(t)),
           jprop._gamma_matrix(jnp.asarray(lam), jnp.asarray(t)))
    x = np.concatenate([np.linspace(-2e-3, 2e-3, 41), [3.0, -7.5]])
    _close(propagate._sinc(_t(x)), jprop._sinc(jnp.asarray(x)), atol=1e-15)


@pytest.mark.parametrize("n", [4, 7])
def test_overlap_ss_matches_jax(n):
    rng = np.random.default_rng(30 + n)
    h0 = _herm(rng, (5,), n)
    x = _controllers(rng, (5,), n)
    want = jprop.overlap_ss(jnp.asarray(h0), jnp.asarray(x), 1, n - 2)
    _close(propagate.overlap_ss(_t(h0), _t(x), 1, n - 2), want)
    _close(ops.overlap_ss(_t(h0), _t(x), 1, n - 2), want)
    # the Jacobi route of the real drift, as the JAX package allows
    jw = jprop.overlap_ss(jnp.asarray(h0.real), jnp.asarray(x), 1, n - 2,
                          eigh=jrf.jacobi_eigh_sym)
    pw = propagate.overlap_ss(_t(h0.real), _t(x), 1, n - 2,
                              eigh=realform.jacobi_eigh_sym)
    _close(pw, jw)


def test_ops_exports_the_jax_names():
    from code_robchar_tpu import ops as jops

    assert set(jops.__all__) <= set(ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
