"""The port's real symmetric Jacobi half (code_robchar_tpu_torch/ops/
realform.py) and the dispatch of its two kernels (ops/cuda_jacobi.py)
against the JAX package: the cyclic order at f64 against the JAX lanes and
scalar functions (1e-10, the repo's parity bar), the round-robin order at
f32 against the Pallas kernels in interpret mode (the bars of
tests/test_pallas.py), and the ring topology's exact degeneracies against
an augmented-expm oracle (1e-10 at f64, 1e-4 at f32).
"""

from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
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


def _sym_lanes(rng, n, b, dtype):
    a = rng.normal(size=(n, n, b))
    return ((a + a.transpose(1, 0, 2)) / 2).astype(dtype), \
        rng.uniform(1, 5, b).astype(dtype)


def _controllers(rng, n, b, dtype, bias=5.0, tmax=20.0):
    h0 = rng.normal(size=(n, n))
    xs = np.column_stack([rng.uniform(-bias, bias, (b, n)),
                          rng.uniform(0.5, tmax, b)])
    return ((h0 + h0.T) / 2).astype(dtype), xs.astype(dtype)


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("n", [2, 4, 5])
def test_cyclic_f64_lanes_match_jax(rng, n):
    a, t = _sym_lanes(rng, n, 32, np.float64)
    i, o = 0, n - 1
    want_r, want_i = jrf.transfer_amp_sym_lanes(jnp.asarray(a),
                                                jnp.asarray(t), i, o)
    got_r, got_i = realform.transfer_amp_sym_lanes(_t(a), _t(t), i, o,
                                                   order="cyclic")
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        realform.fidelity_sym_lanes(_t(a), _t(t), i, o,
                                    order="cyclic").numpy(),
        jrf.fidelity_sym_lanes(jnp.asarray(a), jnp.asarray(t), i, o),
        rtol=0, atol=1e-10)
    lam_j, v_j = jrf.jacobi_eigh_sym_lanes(jnp.asarray(a))
    lam, v = realform.jacobi_eigh_sym_lanes(_t(a), order="cyclic")
    np.testing.assert_allclose(lam.numpy(), lam_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=0, atol=1e-10)

    h0, xs = _controllers(rng, n, 32, np.float64)
    we, wg = jrf.infidelity_and_gradient_sym_lanes(jnp.asarray(h0),
                                                   jnp.asarray(xs), i, o)
    for order in ("cyclic", "roundrobin"):    # both converge at f64
        ge, gg = realform.infidelity_and_gradient_sym_lanes(
            _t(h0), _t(xs), i, o, order=order)
        np.testing.assert_allclose(ge.numpy(), we, rtol=0, atol=1e-10)
        np.testing.assert_allclose(gg.numpy(), wg, rtol=0, atol=1e-10)


def test_scalar_forms_match_jax(rng):
    n = 5
    a, _ = _sym_lanes(rng, n, 6, np.float64)
    a = np.ascontiguousarray(a.transpose(2, 0, 1))          # (6, n, n)
    lam_j, v_j = jrf.jacobi_eigh_sym(jnp.asarray(a))
    lam, v = realform.jacobi_eigh_sym(_t(a))
    np.testing.assert_allclose(lam.numpy(), lam_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=0, atol=1e-10)
    assert bool((lam[:, 1:] >= lam[:, :-1]).all())

    h0, xs = _controllers(rng, n, 7, np.float64)
    want = jax.vmap(lambda x: jrf.fidelity_from_controller_sym(
        jnp.asarray(h0), x, 1, 3))(jnp.asarray(xs))
    got = realform.fidelity_from_controller_sym(_t(h0), _t(xs), 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    # one controller, and a batch of drifts under one controller
    got1 = realform.fidelity_from_controller_sym(_t(h0), _t(xs[2]), 1, 3)
    assert got1.shape == () and abs(float(got1) - float(want[2])) < 1e-10
    hs = np.stack([h0, h0 + np.eye(n)])
    got2 = realform.fidelity_from_controller_sym(_t(hs), _t(xs[0]), 1, 3)
    want2 = jrf.fidelity_from_controller_sym(jnp.asarray(hs),
                                             jnp.asarray(xs[0]), 1, 3)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=0, atol=1e-10)

    we, wg = jrf.infidelity_and_gradient_sym(jnp.asarray(h0),
                                             jnp.asarray(xs), 1, 3)
    ge, gg = realform.infidelity_and_gradient_sym(_t(h0), _t(xs), 1, 3)
    np.testing.assert_allclose(ge.numpy(), we, rtol=0, atol=1e-10)
    np.testing.assert_allclose(gg.numpy(), wg, rtol=0, atol=1e-10)
    e1, g1 = realform.infidelity_and_gradient_sym(_t(h0), _t(xs[0]), 1, 3)
    assert e1.shape == () and g1.shape == (n + 1,)


def test_sinc_matches_jax():
    x = np.array([0.0, 1e-8, -5e-4, 9.99e-4, 1e-3, -0.3, 2.0, 250.0])
    np.testing.assert_allclose(realform._sinc(_t(x)).numpy(),
                               jrf._sinc(jnp.asarray(x)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_roundrobin_f32_amp_matches_pallas_interpret(rng, sweeps):
    """At one sweep the result depends on the pivot order, so agreement
    there pins the schedule as well as the arithmetic; three sweeps
    converge at n = 4 (the interpret-mode build grows with the sweep
    count)."""
    n, b = 4, 128
    a, t = _sym_lanes(rng, n, b, np.float32)
    want_r, want_i = jpj.transfer_amp_sym_pallas(
        jnp.asarray(a), jnp.asarray(t), 0, 2, sweeps=sweeps, tile=b,
        interpret=True)
    got_r, got_i = realform.transfer_amp_sym_lanes(_t(a), _t(t), 0, 2,
                                                   sweeps=sweeps)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0, atol=2e-5)
    if sweeps == 1:
        cyc, _ = realform.transfer_amp_sym_lanes(_t(a), _t(t), 0, 2,
                                                 sweeps=1, order="cyclic")
        assert np.abs(cyc.numpy() - np.asarray(want_r)).max() > 1e-3


def test_roundrobin_f32_grad_matches_pallas_interpret(rng):
    """The Pallas kernel at three sweeps (its interpret-mode build grows
    with the sweep count; the schedule itself is pinned above)."""
    n, b, sweeps = 5, 8, 3
    h0, xs = _controllers(rng, n, b, np.float32)
    want_e, want_g = jpj.infidelity_and_gradient_sym_pallas(
        jnp.asarray(h0), jnp.asarray(xs), 0, 3, sweeps=sweeps, tile=b,
        interpret=True)
    got_e, got_g = realform.infidelity_and_gradient_sym_lanes(
        _t(h0), _t(xs), 0, 3, sweeps=sweeps)
    np.testing.assert_allclose(got_e.numpy(), want_e, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=2e-5, rtol=1e-4)


def _augmented_expm_gradient(h0, x, in_spin, out_spin):
    """The reference's augmented-matrix expm gradient (qnewton.py:162-212)
    in f64 scipy, independent of the Daleckii-Krein formulation."""
    n = h0.shape[0]
    t = abs(x[n])
    h = h0 + np.diag(x[:n])
    th = -1j * t * h
    u = scipy.linalg.expm(th)
    phi = u[out_spin, in_spin]
    grad = np.zeros(n + 1)
    a = np.zeros((2 * n, 2 * n), dtype=complex)
    a[:n, :n] = th
    a[n:, n:] = th
    for l in range(n):
        a[n:, :n] = 0.0
        a[n + l, l] = -1j * t
        du = scipy.linalg.expm(a)[n:, :n]
        grad[l] = -2.0 * (du[out_spin, in_spin] * phi.conjugate()).real
    grad[n] = -2.0 * ((h @ u)[out_spin, in_spin] * phi.conjugate()).imag
    return grad


@pytest.mark.parametrize("n", [5, 6])
def test_gradient_at_ring_degeneracies(n):
    """The ring's exactly degenerate eigenvalue pairs, split by biases of
    scale 0, 1e-4 and 1e-2: oracle-exact at f64 in both orders, within
    1e-4 at f32 through the dispatch (the kernel's order)."""
    rng = np.random.default_rng(42)
    ring = np.eye(n, k=1) + np.eye(n, k=-1)
    ring[0, n - 1] = ring[n - 1, 0] = 1.0
    xs = np.asarray([np.concatenate([rng.uniform(-s, s, n),
                                     rng.uniform(2.0, 20.0, 1)])
                     for s in (0.0, 1e-4, 1e-2) for _ in range(4)])
    oracle = np.asarray([_augmented_expm_gradient(ring, x, 0, n - 1)
                         for x in xs])
    for order in ("cyclic", "roundrobin"):
        _, g64 = realform.infidelity_and_gradient_sym_lanes(
            _t(ring), _t(xs), 0, n - 1, order=order)
        np.testing.assert_allclose(g64.numpy(), oracle, rtol=0, atol=1e-10)
    _, g32 = cuda_jacobi.infidelity_and_gradient_sym(
        _t(ring).float(), _t(xs).float(), 0, n - 1)
    assert np.abs(g32.double().numpy() - oracle).max() < 1e-4


def test_cpu_dispatch_is_the_plain_roundrobin(rng, monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    a, t = (_t(x) for x in _sym_lanes(rng, 6, 32, np.float32))
    got = cuda_jacobi.transfer_amp_sym(a, t, 0, 5)
    want = realform.transfer_amp_sym_lanes(a, t, 0, 5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(cuda_jacobi.fidelity_sym(a, t, 0, 5),
                       want[0] * want[0] + want[1] * want[1])
    h0, xs = (_t(x) for x in _controllers(rng, 6, 16, np.float32))
    got = cuda_jacobi.infidelity_and_gradient_sym(h0, xs, 1, 4)
    want = realform.infidelity_and_gradient_sym_lanes(h0, xs, 1, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not build.LAUNCHES


def test_plain_versions_leave_inputs_untouched(rng):
    a, t = (_t(x) for x in _sym_lanes(rng, 5, 16, np.float64))
    h0, xs = (_t(x) for x in _controllers(rng, 5, 16, np.float64))
    before = [x.clone() for x in (a, t, h0, xs)]
    realform.transfer_amp_sym_lanes(a, t, 0, 4)
    realform.jacobi_eigh_sym_lanes(a)
    realform.infidelity_and_gradient_sym_lanes(h0, xs, 0, 4)
    for x, y in zip((a, t, h0, xs), before):
        assert torch.equal(x, y)


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.transfer_amp_sym_cuda(torch.zeros(4, 4, 8),
                                          torch.zeros(8), 0, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.infidelity_and_gradient_sym_cuda(torch.zeros(4, 4),
                                                     torch.zeros(8, 5), 0, 3)
    assert not build.LAUNCHES


#: each fault the shared checks of utils/build.py refuse, and the message
Z = torch.zeros
BAD_INPUTS = {
    "float64": (lambda: build.check_layout(xs=Z(8, 5, dtype=torch.float64)),
                "float32 only; xs is torch.float64"),
    "noncontiguous": (lambda: build.check_layout(xs=Z(5, 8).T),
                      "xs must be contiguous"),
    "dtype before layout": (
        lambda: build.check_layout(a=Z(5, 8).T, b=Z(8, dtype=torch.float64)),
        "float32 only; b is"),
    "int32 named": (lambda: build.check_layout({"n": torch.int32}, n=Z(8)),
                    "n must be torch.int32, got torch.float32"),
    "int32 unnamed": (lambda: build.check_layout(
        n=Z(8, dtype=torch.int32)), "float32 only; n is torch.int32"),
    "n_large": (lambda: build.check_n(11, 0, 3), "2..10, got n=11"),
    "n_small": (lambda: build.check_n(1), "2..10, got n=1"),
    "spin": (lambda: build.check_n(4, 0, 4),
             r"spins \(0, 4\) out of range for n=4"),
    "negative spin": (lambda: build.check_n(4, -1, 3), "out of range"),
    "off the card": (lambda: build.check_device(a=Z(2, device="meta")),
                     "a must lie on one CUDA device, got meta"),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_kernel_input_checks(bad):
    """What the kernels do not take is refused before any launch."""
    build.check_layout({"n": torch.int32}, a=Z(4, 4, 8),
                       n=Z(8, dtype=torch.int32))
    build.check_n(4, 0, 3)
    build.check_n(10, 9)
    fn, match = BAD_INPUTS[bad]
    with pytest.raises(ValueError, match=match):
        fn()
