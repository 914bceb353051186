"""The CUDA Jacobi kernel on the card (marker ``cuda``; skipped where
torch.cuda.is_available() is False).  Imports no jax, so it also runs on
a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
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
