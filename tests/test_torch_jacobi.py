"""The port's plain Jacobi transfer fidelity (code_robchar_tpu_torch/ops/
realform.py) and the kernel module's dispatch (ops/cuda_jacobi.py) against
the JAX package: the cyclic order at f64 against
realform.fidelity_herm_lanes (1e-10, the repo's parity bar), the
round-robin order at f32 against the Pallas kernel in interpret mode
(3e-5, the bar of tests/test_pallas.py), and an exactly degenerate ring.
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu.ops import pallas_jacobi as jpj
from code_robchar_tpu.ops import realform as jrf
from code_robchar_tpu_torch.ops import cuda_jacobi, realform
from code_robchar_tpu_torch.utils import build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hermitian_lanes(rng, n, b, dtype):
    a = rng.normal(size=(b, n, n))
    sym = (a + a.transpose(0, 2, 1)) / 2
    s = rng.normal(size=(b, n, n))
    skew = (s - s.transpose(0, 2, 1)) / 2
    t = rng.uniform(1, 5, b)
    return (np.moveaxis(sym, 0, -1).astype(dtype).copy(),
            np.moveaxis(skew, 0, -1).astype(dtype).copy(), t.astype(dtype))


def _oracle(ar, ai, t, i, o):
    """LAPACK: |sum_k V[o,k] e^{-i t lam_k} conj V[i,k]|^2 at f64."""
    h = np.moveaxis(ar, -1, 0).astype(np.float64) \
        + 1j * np.moveaxis(ai, -1, 0).astype(np.float64)
    lam, v = np.linalg.eigh(h)
    ph = np.einsum("bk,bk,bk->b", v[:, o, :], np.conj(v[:, i, :]),
                   np.exp(-1j * lam * np.asarray(t, np.float64)[:, None]))
    return np.abs(ph) ** 2


@pytest.mark.parametrize("n", [2, 4, 7])
def test_cyclic_f64_matches_jax_lanes(rng, n):
    ar, ai, t = _hermitian_lanes(rng, n, 64, np.float64)
    want = np.asarray(jrf.fidelity_herm_lanes(
        jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(t), 0, n - 1))
    got = realform.fidelity_herm_lanes(torch.as_tensor(ar),
                                       torch.as_tensor(ai),
                                       torch.as_tensor(t), 0, n - 1,
                                       order="cyclic")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    # the round-robin order converges to the same fidelities at f64
    rr = realform.fidelity_herm_lanes(torch.as_tensor(ar),
                                      torch.as_tensor(ai),
                                      torch.as_tensor(t), 0, n - 1)
    np.testing.assert_allclose(rr.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,sweeps", [(4, 2), (5, 1)])
def test_roundrobin_f32_matches_pallas_interpret(rng, n, sweeps):
    """Before convergence (1-2 sweeps) the result depends on the pivot
    order, so agreement here pins the schedule as well as the
    arithmetic (the cyclic order misses by ~0.1)."""
    b = 128
    ar, ai, t = _hermitian_lanes(rng, n, b, np.float32)
    run = jpj.make_fidelity_kernel(n, 1, 2, sweeps, tile=b, interpret=True)
    want = np.asarray(run(jnp.asarray(ar.reshape(n * n, b)),
                          jnp.asarray(ai.reshape(n * n, b)),
                          jnp.asarray(t).reshape(1, b))).ravel()
    args = (torch.as_tensor(ar), torch.as_tensor(ai), torch.as_tensor(t), 1, 2)
    got = realform.fidelity_herm_lanes(*args, sweeps=sweeps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    cyc = realform.fidelity_herm_lanes(*args, sweeps=sweeps, order="cyclic")
    assert np.abs(cyc.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("n", [4, 6])
def test_degenerate_ring(n):
    """The ring drift with zero bias has exactly degenerate eigenvalue
    pairs (2 cos(2 pi k / n)); the fidelity, a projector quantity, stays
    exact at f64 and at the f32 floor."""
    from code_robchar_tpu.ops import chain as jchain

    h = np.asarray(jchain.xx_hamiltonian_real(n, topo="ring",
                                              dtype=jnp.float64))
    b = 8
    ar = np.repeat(h[:, :, None], b, axis=2)
    ai = np.zeros_like(ar)
    t = np.linspace(0.3, 7.0, b)
    want = _oracle(ar, ai, t, 0, n // 2)
    jax_f64 = np.asarray(jrf.fidelity_herm_lanes(
        jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(t), 0, n // 2))
    for order in ("cyclic", "roundrobin"):
        got = realform.fidelity_herm_lanes(
            torch.as_tensor(ar), torch.as_tensor(ai), torch.as_tensor(t), 0,
            n // 2, order=order).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, jax_f64, rtol=0, atol=1e-10)
    got32 = cuda_jacobi.fidelity_herm(
        torch.as_tensor(ar, dtype=torch.float32),
        torch.as_tensor(ai, dtype=torch.float32),
        torch.as_tensor(t, dtype=torch.float32), 0, n // 2)
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=3e-5)


def test_pair_schedule_matches_jax():
    for n in range(2, 12):
        for order in ("cyclic", "roundrobin"):
            assert realform.pair_schedule(n, order) == \
                jpj.pair_schedule(n, order), (n, order)
    assert cuda_jacobi.pair_schedule is realform.pair_schedule
    with pytest.raises(ValueError):
        realform.pair_schedule(5, "zigzag")


def test_sweep_and_eps_policy_match_jax():
    for n in range(2, 11):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            assert realform._sweeps_for(tdt, n) == jrf._sweeps_for(jdt, n)
            assert realform._eps_for(tdt) == jrf._eps_for(jdt)


def test_plain_version_leaves_inputs_untouched(rng):
    ar, ai, t = (torch.as_tensor(x) for x in
                 _hermitian_lanes(rng, 5, 16, np.float64))
    before = (ar.clone(), ai.clone(), t.clone())
    realform.fidelity_herm_lanes(ar, ai, t, 0, 4)
    for x, y in zip((ar, ai, t), before):
        assert torch.equal(x, y)


def test_dispatch_on_cpu_is_the_plain_roundrobin(rng, monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    ar, ai, t = (torch.as_tensor(x) for x in
                 _hermitian_lanes(rng, 6, 32, np.float32))
    got = cuda_jacobi.fidelity_herm(ar, ai, t, 0, 5)
    want = realform.fidelity_herm_lanes(ar, ai, t, 0, 5)
    assert torch.equal(got, want)
    assert not build.LAUNCHES
