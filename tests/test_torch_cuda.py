"""The CUDA Jacobi kernels on the card (marker ``cuda``; skipped where
torch.cuda.is_available() is False).  Imports no jax, so it also runs on
a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import LBFGS, NMPlus
from code_robchar_tpu_torch.ops import chain, cuda_jacobi, prng, realform

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(n, b, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, b))
    s = rng.normal(size=(n, n, b))
    ar = (a + a.transpose(1, 0, 2)) / 2
    ai = (s - s.transpose(1, 0, 2)) / 2
    t = rng.uniform(1, 5, b)
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in (ar, ai, t))


@pytest.mark.parametrize("n", range(2, 11))
def test_kernel_matches_plain_version(dev, n):
    ar, ai, t = _batch(n, 1000 + n, dev, seed=n)    # ragged tail
    before = cuda_jacobi.LAUNCHES
    got = cuda_jacobi.fidelity_herm(ar, ai, t, 0, n - 1)
    want = realform.fidelity_herm_lanes(ar, ai, t, 0, n - 1)
    torch.cuda.synchronize()
    assert cuda_jacobi.LAUNCHES == before + 1
    assert got.shape == t.shape and got.device == ar.device
    assert float((got - want).abs().max()) <= 3e-5


def test_kernel_refuses_float64_and_odd_layouts(dev):
    ar, ai, t = _batch(5, 64, dev)
    before = cuda_jacobi.LAUNCHES
    with pytest.raises(ValueError, match="float32"):
        cuda_jacobi.fidelity_herm(ar.double(), ai.double(), t.double(), 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_jacobi.fidelity_herm(ar.transpose(0, 1), ai, t, 0, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.fidelity_herm(ar, ai, t.cpu(), 0, 4)
    assert cuda_jacobi.LAUNCHES == before
    assert cuda_jacobi.fidelity_herm(ar[..., :0].contiguous(),
                                     ai[..., :0].contiguous(), t[:0], 0,
                                     4).shape == (0,)


def test_engine_on_card_matches_cpu(dev):
    rng = np.random.default_rng(1)
    n = 5
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float32)
    ctrl = np.column_stack([rng.uniform(-3, 3, (6, n)),
                            rng.uniform(0.5, 4, 6)]).astype(np.float32)
    noises = np.array([0.0, 0.05], np.float32)
    key = prng.key(7)
    got = engine.mc_fidelity_sweep(h0, ctrl, noises, key, 32, 0, n - 1,
                                   device=dev)
    want = engine.mc_fidelity_sweep(h0, ctrl, noises, key, 32, 0, n - 1,
                                    device="cpu")
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 3e-5


def _sym_batch(n, b, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, b))
    h0 = rng.normal(size=(n, n))
    xs = np.column_stack([rng.uniform(-2, 2, (b, n)), rng.uniform(0.5, 5, b)])
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in ((a + a.transpose(1, 0, 2)) / 2, rng.uniform(1, 5, b),
                           (h0 + h0.T) / 2, xs))


@pytest.mark.parametrize("n", range(2, 11))
def test_sym_kernels_match_plain_versions(dev, n):
    a, t, h0, xs = _sym_batch(n, 1000 + n, dev, seed=n)    # ragged tail
    amp0, grad0 = cuda_jacobi.SYM_AMP_LAUNCHES, cuda_jacobi.SYM_GRAD_LAUNCHES
    got = cuda_jacobi.transfer_amp_sym(a, t, 0, n - 1)
    want = realform.transfer_amp_sym_lanes(a, t, 0, n - 1)
    err, grad = cuda_jacobi.infidelity_and_gradient_sym(h0, xs, 1 % n, n - 1)
    werr, wgrad = realform.infidelity_and_gradient_sym_lanes(h0, xs, 1 % n,
                                                             n - 1)
    torch.cuda.synchronize()
    assert cuda_jacobi.SYM_AMP_LAUNCHES == amp0 + 1
    assert cuda_jacobi.SYM_GRAD_LAUNCHES == grad0 + 1
    for g, w in zip(got, want):
        assert g.shape == t.shape and float((g - w).abs().max()) <= 3e-5
    assert err.shape == (xs.shape[0],) and grad.shape == xs.shape
    assert bool(((err - werr).abs() <= 2e-6 + 1e-5 * werr.abs()).all())
    assert bool(((grad - wgrad).abs() <= 2e-5 + 1e-4 * wgrad.abs()).all())


def test_sym_kernels_refuse_float64_and_odd_layouts(dev):
    a, t, h0, xs = _sym_batch(5, 64, dev)
    before = (cuda_jacobi.SYM_AMP_LAUNCHES, cuda_jacobi.SYM_GRAD_LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        cuda_jacobi.transfer_amp_sym(a.double(), t.double(), 0, 4)
    with pytest.raises(ValueError, match="float32"):
        cuda_jacobi.infidelity_and_gradient_sym(h0.double(), xs.double(), 0,
                                                4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_jacobi.transfer_amp_sym(a.transpose(0, 1), t, 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_jacobi.infidelity_and_gradient_sym(h0, xs.T.contiguous().T, 0,
                                                4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.transfer_amp_sym(a, t.cpu(), 0, 4)
    assert (cuda_jacobi.SYM_AMP_LAUNCHES,
            cuda_jacobi.SYM_GRAD_LAUNCHES) == before
    phr, phi = cuda_jacobi.transfer_amp_sym(a[..., :0].contiguous(), t[:0],
                                            0, 4)
    assert phr.shape == phi.shape == (0,)


@pytest.mark.parametrize("cls", [LBFGS, NMPlus])
def test_optimizers_on_card_match_cpu(dev, cls):
    """32 restarts at N=4 through the kernels against the plain versions
    on the CPU, both float32, over their first iterations: over whole runs
    float32 rounding flips line-search and simplex comparisons and the
    trajectories part, as they do when the starts move by one ulp on either
    device alone (chip_smoke.py prints both counts)."""
    kw = dict(testing=True, seed=2, lane_width=16)
    if cls is LBFGS:
        kw["maxiter"] = 3
    else:
        kw["maxfev"] = 30
    gpu = cls(4, 0, 2, device=dev, **kw)
    cpu = cls(4, 0, 2, device="cpu", **kw)
    x0 = gpu.init_points(32)
    keys = prng.split(prng.key(0), 32)
    launches = (cuda_jacobi.SYM_AMP_LAUNCHES, cuda_jacobi.SYM_GRAD_LAUNCHES)
    got = gpu._run_batch(torch.as_tensor(x0, dtype=torch.float32,
                                         device=dev), keys)
    want = cpu._run_batch(torch.as_tensor(x0, dtype=torch.float32), keys)
    assert cuda_jacobi.SYM_AMP_LAUNCHES > launches[0]
    if cls is LBFGS:
        assert cuda_jacobi.SYM_GRAD_LAUNCHES > launches[1]
    assert got.x.device.type == "cuda"
    dx = (got.x.cpu() - want.x).abs().amax(1)
    assert int((dx <= 1e-3).sum()) >= 28, dx
    assert float((got.fid.cpu() - want.fid).abs().median()) <= 1e-4
