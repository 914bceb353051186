"""The CUDA kernels on the card (marker ``cuda``; skipped where
torch.cuda.is_available() is False).  Imports no jax, so it also runs on
a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import LBFGS, NMPlus
from code_robchar_tpu_torch.ops import (chain, cuda_jacobi, mc_draws, noise,
                                       prng, realform)
from code_robchar_tpu_torch.utils import build

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
    before = build.LAUNCHES["herm_jacobi_fidelity"]
    got = cuda_jacobi.fidelity_herm(ar, ai, t, 0, n - 1)
    want = realform.fidelity_herm_lanes(ar, ai, t, 0, n - 1)
    torch.cuda.synchronize()
    assert build.LAUNCHES["herm_jacobi_fidelity"] == before + 1
    assert got.shape == t.shape and got.device == ar.device
    assert float((got - want).abs().max()) <= 3e-5


def test_kernel_refuses_float64_and_odd_layouts(dev):
    ar, ai, t = _batch(5, 64, dev)
    before = build.LAUNCHES["herm_jacobi_fidelity"]
    with pytest.raises(ValueError, match="float32"):
        cuda_jacobi.fidelity_herm(ar.double(), ai.double(), t.double(), 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_jacobi.fidelity_herm(ar.transpose(0, 1), ai, t, 0, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.fidelity_herm(ar, ai, t.cpu(), 0, 4)
    assert build.LAUNCHES["herm_jacobi_fidelity"] == before
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


def _draw_inputs(n, dev, num_c=40, num_l=11, seed=0):
    rng = np.random.default_rng(seed)
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float32, device=dev)
    ctrl = torch.as_tensor(np.column_stack([rng.uniform(-10, 10, (num_c, n)),
                                            rng.uniform(0, 30, num_c)]),
                           dtype=torch.float32, device=dev)
    noises = torch.as_tensor(np.linspace(0, 0.1, num_l), dtype=torch.float32,
                             device=dev)
    return h0, ctrl, noises


def _bits(x):
    return x.view(torch.int32)


#: (start, count, c_offset, c_global) on the (11, 40, 100) lattice of
#: _draw_inputs, or, for a block (c_offset > 0), of its 16 controllers from
#: c_offset: a whole chunk from 0, one that starts mid-lattice, the partial
#: last one, a mesh block's chunk (the block starting at controller 24 of 64)
DRAW_CASES = {"first": (0, 13_000, 0, None),
              "mid": (7_777, 13_000, 0, None),
              "partial_last": (44_000 - 1_234, 1_234, 0, None),
              "mesh_block": (3_001, 9_000, 24, 64)}


@pytest.mark.parametrize("case", sorted(DRAW_CASES))
@pytest.mark.parametrize("cx", [True, False])
@pytest.mark.parametrize("n", [5, 7])
def test_draw_kernel_equals_torch_route_bitwise(dev, n, cx, case):
    """csrc/mc_draw_lanes.cu writes the (ar, ai, t) of the torch route on
    the card (prng.fold_in of the same global ids, noise.assemble_lanes)
    in every bit."""
    start, count, c_offset, c_global = DRAW_CASES[case]
    h0, ctrl, noises = _draw_inputs(n, dev, seed=n)
    if c_offset:
        ctrl = ctrl[:16].contiguous()
    key = prng.fold_in(prng.key(2**35 + 3, device=dev), n)
    c_glob = ctrl.shape[0] if c_global is None else c_global
    gids, l_idx, c_idx = mc_draws.lattice_ids(start, count, 100,
                                              ctrl.shape[0], c_offset,
                                              c_glob, dev)
    route = noise.assemble_lanes(h0, ctrl[c_idx], noises[l_idx],
                                 prng.fold_in(key, gids), cx)
    before = build.LAUNCHES["mc_draw_lanes"]
    got = mc_draws.draw_lanes(h0, ctrl, noises, key, start, count, 100, cx,
                              c_offset, c_global)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mc_draw_lanes"] == before + 1
    for g, want in zip(got, route):
        assert g.device == want.device and g.shape == want.shape
        assert torch.equal(_bits(g), _bits(want))


def test_characterise_on_card_equals_the_torch_route(dev, monkeypatch):
    """characterise(..., return_fids=False) on the card reads the metric
    tensors of the parent route (the draws in torch ops, then kernel 1),
    and the kernel route launches the draw kernel once a chunk."""
    n = 7
    h0, ctrl, noises = _draw_inputs(n, dev, num_c=300, seed=4)
    key = prng.key(2**33 + 21, device=dev)
    kw = dict(alpha=0.05, complex_offdiag=True, chunk=4_000,
              return_fids=False, device=dev)
    before = build.LAUNCHES["mc_draw_lanes"]
    got = engine.characterise(h0, ctrl, noises, key, 100, 0, 6, **kw)
    torch.cuda.synchronize()
    chunks = -(-11 * 300 // 40)           # 40 cells (4,000 elements) a chunk
    assert build.LAUNCHES["mc_draw_lanes"] == before + chunks
    monkeypatch.setattr(mc_draws, "draw_lanes", mc_draws.draw_lanes_plain)
    want = engine.characterise(h0, ctrl, noises, key, 100, 0, 6, **kw)
    assert build.LAUNCHES["mc_draw_lanes"] == before + chunks
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_draw_kernel_refuses_what_it_does_not_take(dev):
    h0, ctrl, noises = _draw_inputs(5, dev)
    key = prng.key(1, device=dev)
    before = build.LAUNCHES["mc_draw_lanes"]
    args = (0, 100, 100)
    with pytest.raises(ValueError, match="float32"):
        mc_draws.draw_lanes(h0.double(), ctrl.double(), noises.double(), key,
                            *args)
    with pytest.raises(ValueError, match="contiguous"):
        mc_draws.draw_lanes(h0, ctrl.T.contiguous().T, noises, key, *args)
    with pytest.raises(ValueError, match="device"):
        mc_draws.draw_lanes(h0, ctrl, noises, key.cpu(), *args)
    with pytest.raises(ValueError, match="device"):
        mc_draws.draw_lanes_cuda(h0.cpu(), ctrl.cpu(), noises.cpu(),
                                 key.cpu(), *args)
    assert build.LAUNCHES["mc_draw_lanes"] == before
    ar, ai, t = mc_draws.draw_lanes(h0, ctrl, noises, key, 0, 0, 100)
    assert ar.shape == (5, 5, 0) and t.shape == (0,)
    assert build.LAUNCHES["mc_draw_lanes"] == before


def _sym_batch(n, b, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, b))
    h0 = rng.normal(size=(n, n))
    xs = np.column_stack([rng.uniform(-2, 2, (b, n)), rng.uniform(0.5, 5, b)])
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in ((a + a.transpose(1, 0, 2)) / 2, rng.uniform(1, 5, b),
                           (h0 + h0.T) / 2, xs))


def _count(*names):
    """The launches of the C entries ``names``, in that order."""
    return tuple(build.LAUNCHES[name] for name in names)


def _sym_launches():
    """(amplitude launches, gradient launches), both kernels of each."""
    return (sum(_count("sym_jacobi_amp", "sym_jacobi_amp_group")),
            sum(_count("sym_jacobi_grad", "sym_jacobi_grad_group")))


@pytest.mark.parametrize("n", range(2, 11))
def test_sym_kernels_match_plain_versions(dev, n):
    a, t, h0, xs = _sym_batch(n, 1000 + n, dev, seed=n)    # ragged tail
    amp0, grad0 = _sym_launches()
    got = cuda_jacobi.transfer_amp_sym(a, t, 0, n - 1)
    want = realform.transfer_amp_sym_lanes(a, t, 0, n - 1)
    err, grad = cuda_jacobi.infidelity_and_gradient_sym(h0, xs, 1 % n, n - 1)
    werr, wgrad = realform.infidelity_and_gradient_sym_lanes(h0, xs, 1 % n,
                                                             n - 1)
    torch.cuda.synchronize()
    assert _sym_launches() == (amp0 + 1, grad0 + 1)
    for g, w in zip(got, want):
        assert g.shape == t.shape and float((g - w).abs().max()) <= 3e-5
    assert err.shape == (xs.shape[0],) and grad.shape == xs.shape
    assert bool(((err - werr).abs() <= 2e-6 + 1e-5 * werr.abs()).all())
    assert bool(((grad - wgrad).abs() <= 2e-5 + 1e-4 * wgrad.abs()).all())


def _hold_sym_kernels(amp_kernel, grad_kernel, n, b, dev):
    a, t, h0, xs = _sym_batch(n, b, dev, seed=n + b)
    got = cuda_jacobi.transfer_amp_sym_kernel(amp_kernel, a, t, 0, n - 1)
    want = realform.transfer_amp_sym_lanes(a, t, 0, n - 1)
    err, grad = cuda_jacobi.infidelity_and_gradient_sym_kernel(
        grad_kernel, h0, xs, 1 % n, n - 1)
    werr, wgrad = realform.infidelity_and_gradient_sym_lanes(h0, xs, 1 % n,
                                                             n - 1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == t.shape and float((g - w).abs().max()) <= 3e-5
    assert err.shape == (b,) and grad.shape == xs.shape
    assert bool(((err - werr).abs() <= 2e-6 + 1e-5 * werr.abs()).all())
    assert bool(((grad - wgrad).abs() <= 2e-5 + 1e-4 * wgrad.abs()).all())


@pytest.mark.parametrize("n", range(3, 11))
def test_group_kernels_match_plain_at_ragged_batches(dev, n):
    """The lane-group kernels at batches that end inside a warp, inside a
    group's warp share and on one matrix; every in / out pair of lanes is
    reached over the sizes."""
    before = _count("sym_jacobi_amp_group", "sym_jacobi_grad_group")
    for b in (1, 7, 33, 1000 + n):
        _hold_sym_kernels("sym_jacobi_amp_group", "sym_jacobi_grad_group", n,
                          b, dev)
    assert _count("sym_jacobi_amp_group", "sym_jacobi_grad_group") == (
        before[0] + 4, before[1] + 4)


@pytest.mark.parametrize("n", range(2, 11))
def test_one_thread_kernels_match_plain_at_ragged_batches(dev, n):
    for b in (1, 7, 33, 1000 + n):
        _hold_sym_kernels("sym_jacobi_amp", "sym_jacobi_grad", n, b, dev)


@pytest.mark.parametrize("spins", [(0, 6), (3, 4), (5, 1), (6, 6), (2, 2)])
def test_group_kernels_take_every_spin_pair(dev, spins):
    """in and out rows held by the same lane, by different lanes, in either
    register row (n = 7: lane l % 4, row l // 4)."""
    a, t, h0, xs = _sym_batch(7, 300, dev, seed=sum(spins))
    got = cuda_jacobi.transfer_amp_sym_kernel("sym_jacobi_amp_group", a, t,
                                              *spins)
    want = realform.transfer_amp_sym_lanes(a, t, *spins)
    err, grad = cuda_jacobi.infidelity_and_gradient_sym_kernel(
        "sym_jacobi_grad_group", h0, xs, *spins)
    werr, wgrad = realform.infidelity_and_gradient_sym_lanes(h0, xs, *spins)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 3e-5
    assert bool(((err - werr).abs() <= 2e-6 + 1e-5 * werr.abs()).all())
    assert bool(((grad - wgrad).abs() <= 2e-5 + 1e-4 * wgrad.abs()).all())


@pytest.mark.parametrize("kind", ["amp", "grad"])
def test_dispatch_takes_the_routed_kernel_on_both_sides(dev, kind):
    """At the largest batch of the lane-group route and one past it the
    dispatch launches the kernel that the route function names, and both
    agree with the plain version."""
    n = 7
    edge = cuda_jacobi.AMP_GROUP_MAX_B if kind == "amp" \
        else cuda_jacobi.GRAD_GROUP_MAX_B
    names = ("sym_jacobi_amp", "sym_jacobi_amp_group") if kind == "amp" \
        else ("sym_jacobi_grad", "sym_jacobi_grad_group")
    for b, moved in ((edge, (0, 1)), (edge + 1, (1, 0))):
        a, t, h0, xs = _sym_batch(n, b, dev, seed=b % 1000)
        before = _count(*names)
        if kind == "amp":
            got = cuda_jacobi.transfer_amp_sym(a, t, 0, n - 1)
            want = realform.transfer_amp_sym_lanes(a, t, 0, n - 1)
            bars = (3e-5, 0.0)
        else:
            got = cuda_jacobi.infidelity_and_gradient_sym(h0, xs, 0, n - 1)
            want = realform.infidelity_and_gradient_sym_lanes(h0, xs, 0,
                                                              n - 1)
            bars = (2e-5, 1e-4)
        after = _count(*names)
        assert tuple(y - x for x, y in zip(before, after)) == moved
        for g, w in zip(got, want):
            assert bool(((g - w).abs() <= bars[0] + bars[1] * w.abs()).all())


def test_group_kernels_refuse_n2(dev):
    a, t, h0, xs = _sym_batch(2, 16, dev)
    with pytest.raises(ValueError, match="3..10"):
        cuda_jacobi.transfer_amp_sym_kernel("sym_jacobi_amp_group", a, t, 0,
                                            1)
    with pytest.raises(ValueError, match="3..10"):
        cuda_jacobi.infidelity_and_gradient_sym_kernel(
            "sym_jacobi_grad_group", h0, xs, 0, 1)
    with pytest.raises(ValueError, match="unknown kernel"):
        cuda_jacobi.transfer_amp_sym_kernel("sym_jacobi_grad", a, t, 0, 1)


def test_launch_floor_runs(dev):
    cuda_jacobi.launch_floor(dev)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.launch_floor("cpu")


def _pivot_operands(kind, count, seed):
    """(3, count) float32 rows app, aqq, apq: "wide" has magnitudes spread
    over 2^-45..2^45 with either sign, exact zeros and equal diagonals
    among them; "matrix" has the entries of standard normal matrices."""
    rng = np.random.default_rng(seed)
    if kind == "matrix":
        return rng.normal(size=(3, count)).astype(np.float32)
    x = (rng.choice([-1.0, 1.0], (3, count)) * rng.uniform(1, 2, (3, count))
         * 2.0 ** rng.integers(-45, 46, (3, count)))
    x[0, ::7] = x[1, ::7]          # tau = 0
    x[2, ::11] = 0.0               # nothing to rotate
    x[0, ::13] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["wide", "matrix"])
def test_fast_angle_paths_equal_division_and_sqrtf_bitwise(dev, kind):
    """div_fast, sqrt_fast and sym_angles_fast of csrc/jacobi_common.cuh
    give the bits of `/`, sqrtf and sym_angles wherever their operands are
    in the ranges they check (a zero quotient aside, whose sign the angles
    do not read); matrix entries of order one are in range."""
    x = torch.as_tensor(_pivot_operands(kind, 1 << 21, 5), device=dev)
    exact, fast = cuda_jacobi.angles_probe(x)
    flags = fast[6].to(torch.int32)
    same = exact.view(torch.int32) == fast[:6].view(torch.int32)
    ok_angles, ok_div, ok_sqrt = ((flags & m) != 0 for m in (1, 2, 4))
    assert bool(same[:4, ok_angles].all())
    assert bool((exact[4] == fast[4])[ok_div].all())
    assert bool(same[5, ok_sqrt].all())
    assert bool(torch.isfinite(exact[:4]).all())
    share = float(ok_angles.float().mean())
    assert share > (0.999 if kind == "matrix" else 0.3)
    assert int(ok_div.sum()) > 0 and int(ok_sqrt.sum()) > 0
    with pytest.raises(ValueError, match="\\(3, B\\)"):
        cuda_jacobi.angles_probe(x[:2].contiguous())


def _herm_pivot_operands(kind, count, seed):
    """(4, count) float32 rows app, aqq, xr, xi of Hermitian pivots:
    "matrix" standard normal entries; "zero" the same with A[P][Q] = 0, as
    on every pivot an earlier rotation zeroed; "tiny" an A[P][Q] of
    2^-75..2^-45, whose |.|^2 lies below 2^-100 or is subnormal; "wide"
    magnitudes spread over 2^-45..2^45 with either sign, zeros and equal
    diagonals among them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, count))
    if kind == "zero":
        x[2:] = 0.0
    elif kind == "tiny":
        x[2:] = (rng.choice([-1.0, 1.0], (2, count))
                 * rng.uniform(1, 2, (2, count))
                 * 2.0 ** rng.integers(-75, -44, (2, count)))
    elif kind == "wide":
        x = (rng.choice([-1.0, 1.0], (4, count))
             * rng.uniform(1, 2, (4, count))
             * 2.0 ** rng.integers(-45, 46, (4, count)))
        x[0, ::7] = x[1, ::7]
        x[2, ::11] = 0.0
        x[3, ::5] = 0.0
        x[0, ::13] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("kind,least", [("matrix", 0.999), ("zero", 1.0),
                                        ("tiny", 0.99), ("wide", 0.3)])
def test_herm_fast_angle_paths_equal_division_and_sqrtf_bitwise(dev, kind,
                                                                least):
    """herm_angles_fast of csrc/jacobi_common.cuh gives the bits of
    herm_angles (IEEE `/` and sqrtf) wherever it reports its operands in
    range, and the ranges cover matrix entries of order one, zeroed pivots
    and pivots too small to rotate."""
    x = torch.as_tensor(_herm_pivot_operands(kind, 1 << 21, 9), device=dev)
    exact, fast = cuda_jacobi.herm_angles_probe(x)
    ok = fast[7] != 0
    same = exact.view(torch.int32) == fast[:7].view(torch.int32)
    assert bool(same[:, ok].all())
    assert bool(torch.isfinite(exact).all())
    assert float(ok.float().mean()) >= least
    with pytest.raises(ValueError, match="\\(4, B\\)"):
        cuda_jacobi.herm_angles_probe(x[:3].contiguous())


def test_sym_kernels_refuse_float64_and_odd_layouts(dev):
    a, t, h0, xs = _sym_batch(5, 64, dev)
    before = _sym_launches()
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
    assert _sym_launches() == before
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
    launches = _sym_launches()
    got = gpu._run_batch(torch.as_tensor(x0, dtype=torch.float32,
                                         device=dev), keys)
    want = cpu._run_batch(torch.as_tensor(x0, dtype=torch.float32), keys)
    assert _sym_launches()[0] > launches[0]
    if cls is LBFGS:
        assert _sym_launches()[1] > launches[1]
    assert got.x.device.type == "cuda"
    dx = (got.x.cpu() - want.x).abs().amax(1)
    assert int((dx <= 1e-3).sum()) >= 28, dx
    assert float((got.fid.cpu() - want.fid).abs().median()) <= 1e-4


def _rollout_case(n, hid, a_cnt, t_len, dev, seed=0):
    """Random actor weights (A agents, hidden width hid) and a carry away
    from the wrap boundaries, float32 on ``dev``."""
    from code_robchar_tpu_torch.ops import rollout

    rng = np.random.default_rng(seed)
    d = n + 1
    params = {}
    for i, (i_, o) in enumerate([(d, hid), (hid, hid), (hid, d)]):
        params[f"pi/Dense_{i}/kernel"] = rng.normal(0, 1 / np.sqrt(i_),
                                                    (a_cnt, i_, o))
        params[f"pi/Dense_{i}/bias"] = rng.normal(0, 0.1, (a_cnt, o))
    params["pi/log_std"] = rng.normal(-0.5, 0.2, (a_cnt, d))
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in params.items()}
    f32 = dict(dtype=torch.float32, device=dev)
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float32, device=dev)
    return (*rollout.fold_actor_weights(params), h0,
            torch.as_tensor(rng.uniform(-4, 4, (n, a_cnt)), **f32),
            torch.as_tensor(rng.uniform(2, 20, a_cnt), **f32),
            torch.as_tensor(rng.integers(0, 3, a_cnt), dtype=torch.int32,
                            device=dev),
            torch.as_tensor(rng.normal(size=(t_len, d, a_cnt)), **f32),
            torch.as_tensor(rng.normal(0, 0.05, (t_len, n, a_cnt)), **f32),
            torch.as_tensor(rng.normal(0, 0.05, (t_len, n - 1, a_cnt)),
                            **f32))


@pytest.mark.parametrize("n,hid,ham_noisy", [(2, 16, True), (4, 16, False),
                                             (7, 100, True), (10, 40, True),
                                             (3, 100, False), (10, 100, True),
                                             (7, 64, True)])
def test_rollout_kernel_matches_plain_version(dev, n, hid, ham_noisy):
    """Both kernels: h = 100 takes the one that keeps W2 in registers
    (outputs reduced over 4, 8 or 16 slots at n = 3, 7, 10), the other
    widths the generic one; each counts its own launches."""
    from code_robchar_tpu_torch.ops import rollout

    args = _rollout_case(n, hid, 70, 20, dev, seed=n)
    kw = dict(in_spin=0, out_spin=n - 1, sweeps=4, bmax=10.0, maxtime=30.0,
              max_ep_len=7, ham_noisy=ham_noisy)
    before = _count("actor_env_rollout_reg", "actor_env_rollout")
    got = rollout.actor_env_rollout(*args, **kw)
    want = rollout.actor_env_rollout_plain(*args, **kw)
    torch.cuda.synchronize()
    reg = int(hid == rollout.REG_HIDDEN)
    assert _count("actor_env_rollout_reg", "actor_env_rollout") == (
        before[0] + reg, before[1] + 1 - reg)
    for name in ("a", "fid", "obs2", "next_action", "next_t"):
        err = float((getattr(got, name) - getattr(want, name)).abs().max())
        assert err <= 1e-4, (name, err)
    for name in ("done", "timeout", "next_ep"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool(got.timeout.any())


@pytest.mark.parametrize("hid,t_len,a_cnt,share", [
    (16, 37, 5, 0.0), (100, 64, 5, 0.0),
    # ragged (T no multiple of the 100-row tile, h none of 4) and the
    # widest width at d + 1 = 9 (a 10-row tile, the gradient summed in
    # shared memory), at chip_smoke.py's bars: a share of 1e-5 of the
    # elements may be past atol 2e-6 + rtol 1e-5 (a gradient within
    # rounding of zero that flips sign moves its element by lr a step)
    (30, 300, 130, 1e-5), (157, 129, 132, 1e-5)])
def test_critic_kernel_matches_plain_version(dev, hid, t_len, a_cnt, share):
    from code_robchar_tpu_torch.ops import critic

    rng = np.random.default_rng(hid)
    d = 8
    p = critic.n_params(d + 1, hid)
    f32 = dict(dtype=torch.float32, device=dev)
    theta = torch.as_tensor(rng.normal(0, 0.2, (a_cnt, p)), **f32)
    mu = torch.as_tensor(rng.normal(0, 1e-3, (a_cnt, p)), **f32)
    nu = torch.as_tensor(rng.uniform(0, 1e-5, (a_cnt, p)), **f32)
    count = torch.as_tensor(rng.integers(0, 5, a_cnt), dtype=torch.int32,
                            device=dev)
    obs = torch.as_tensor(rng.normal(size=(a_cnt, t_len, d)), **f32)
    rets = torch.as_tensor(rng.normal(size=(a_cnt, t_len)), **f32)
    kw = dict(h=hid, iters=7, lr=1e-3)
    before = build.LAUNCHES["critic_train"]
    got = critic.critic_train_packed(theta, mu, nu, count, obs, rets, **kw)
    want = critic.critic_train_plain(theta, mu, nu, count, obs, rets, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["critic_train"] == before + 1
    over = 0
    for g, w in zip(got[:3], want[:3]):
        over += int(((g - w).abs() > 2e-6 + 1e-5 * w.abs()).sum())
        assert float((g - w).abs().max()) <= 2 * 1e-3 * 7
    assert over <= share * 3 * got[0].numel(), over
    assert torch.equal(got[3], count + 7)


def _critic_bf16_case(hid, t_len, a_cnt, dev, d=8):
    rng = np.random.default_rng(hid + t_len + a_cnt)
    from code_robchar_tpu_torch.ops import critic

    p = critic.n_params(d + 1, hid)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(rng.normal(0, 0.2, (a_cnt, p)), **f32),
            torch.zeros((a_cnt, p), **f32), torch.zeros((a_cnt, p), **f32),
            torch.as_tensor(rng.integers(0, 5, a_cnt), dtype=torch.int32,
                            device=dev),
            torch.as_tensor(rng.normal(size=(a_cnt, t_len, d)), **f32),
            torch.as_tensor(rng.normal(size=(a_cnt, t_len)), **f32))


@pytest.mark.parametrize("a_cnt", [1, 50])
@pytest.mark.parametrize("hid,t_len", [(100, 500), (20, 37), (30, 64)])
def test_critic_bf16_kernel_matches_plain_version(dev, hid, t_len, a_cnt):
    """The bf16 tensor-core kernel against critic_train_plain(
    fast_dot=True), the bars of chip_smoke.py: one iteration from zero
    moments reads the gradient (mu = 0.1 g) to 2e-4 of its largest element;
    after seven, every element within 2 lr iters and the share of elements
    past atol 2e-6 + rtol 1e-5 at most twice that of the plain version
    against itself with theta moved one ulp, plus 5e-3."""
    from code_robchar_tpu_torch.ops import critic

    def share_past(xs, ys):
        over = sum(int(((x - y).abs() > 2e-6 + 1e-5 * y.abs()).sum())
                   for x, y in zip(xs, ys))
        return over / sum(y.numel() for y in ys)

    args = _critic_bf16_case(hid, t_len, a_cnt, dev)
    before = _count("critic_train", "critic_train_bf16")
    kw = dict(h=hid, lr=1e-3, fast_dot=True)
    got = critic.critic_train_packed(*args, iters=1, **kw)
    want = critic.critic_train_plain(*args, iters=1, **kw)
    torch.cuda.synchronize()
    assert _count("critic_train", "critic_train_bf16") == (before[0],
                                                          before[1] + 1)
    assert float((got[1] - want[1]).abs().max()) <= \
        2e-4 * float(want[1].abs().max())
    assert torch.equal(got[3], args[3] + 1)

    got = critic.critic_train_packed(*args, iters=7, **kw)
    want = critic.critic_train_plain(*args, iters=7, **kw)
    moved = torch.nextafter(args[0], torch.full_like(args[0], np.inf))
    witness = critic.critic_train_plain(moved, *args[1:], iters=7, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 2 * 1e-3 * 7
    assert share_past(got[:3], want[:3]) <= \
        2 * share_past(witness[:3], want[:3]) + 5e-3
    assert torch.equal(got[3], args[3] + 7)


@pytest.mark.parametrize("fast_dot", [False, True])
def test_critic_kernels_copy_state_at_zero_iters(dev, fast_dot):
    from code_robchar_tpu_torch.ops import critic

    args = list(_critic_bf16_case(30, 64, 5, dev))
    args[1] = torch.rand_like(args[1])
    args[2] = torch.rand_like(args[2])
    got = critic.critic_train_packed(*args, h=30, iters=0, lr=1e-3,
                                     fast_dot=fast_dot)
    torch.cuda.synchronize()
    for g, w in zip(got, args[:4]):
        assert torch.equal(g, w)


def test_critic_bf16_kernel_refuses_what_it_does_not_take(dev):
    from code_robchar_tpu_torch.ops import critic

    before = build.LAUNCHES["critic_train_bf16"]
    kw = dict(iters=1, lr=1e-3, fast_dot=True)
    with pytest.raises(ValueError, match="float32"):
        critic.critic_train_packed(
            *(x.double() if x.is_floating_point() else x
              for x in _critic_bf16_case(20, 37, 2, dev)), h=20, **kw)
    with pytest.raises(ValueError, match="a width of 111"):
        critic.critic_train_packed(*_critic_bf16_case(112, 8, 1, dev), h=112,
                                   **kw)
    with pytest.raises(ValueError, match="shared memory"):
        critic.critic_train_packed(*_critic_bf16_case(107, 8, 1, dev), h=107,
                                   **kw)
    with pytest.raises(ValueError, match="at most 15 inputs"):
        critic.critic_train_packed(*_critic_bf16_case(16, 8, 1, dev, d=16),
                                   h=16, **kw)
    assert build.LAUNCHES["critic_train_bf16"] == before
    # the widest critic the kernel takes at 8 inputs
    args = _critic_bf16_case(106, 40, 2, dev)
    got = critic.critic_train_packed(*args, h=106, **kw)
    want = critic.critic_train_plain(*args, h=106, **kw)
    torch.cuda.synchronize()
    assert float((got[1] - want[1]).abs().max()) <= \
        2e-4 * float(want[1].abs().max())


def test_ppo_kernels_refuse_float64(dev):
    from code_robchar_tpu_torch.ops import critic, rollout

    args = [x.double() if x.is_floating_point() else x
            for x in _rollout_case(4, 16, 8, 3, dev)]
    names = ("actor_env_rollout", "actor_env_rollout_reg", "critic_train")
    before = _count(*names)
    with pytest.raises(ValueError, match="float32"):
        rollout.actor_env_rollout(*args, in_spin=0, out_spin=3, sweeps=4,
                                  bmax=10.0, maxtime=30.0, max_ep_len=5,
                                  ham_noisy=True)
    x = torch.zeros((2, critic.n_params(5, 16)), dtype=torch.float64,
                    device=dev)
    with pytest.raises(ValueError, match="float32"):
        critic.critic_train_packed(
            x, x, x, torch.zeros(2, dtype=torch.int32, device=dev),
            torch.zeros((2, 3, 4), dtype=torch.float64, device=dev),
            torch.zeros((2, 3), dtype=torch.float64, device=dev), h=16,
            iters=1, lr=1e-3)
    assert _count(*names) == before


def test_ppo_epoch_on_card_matches_cpu(dev):
    """One epoch at N=4, 16 agents, T=16 through the kernels on the card
    against the plain versions on the CPU, both float32, from one state.
    On the card the epoch takes the bf16 critic kernel (fast_dot=True) once
    and the float32 one not at all, and the rollout kernel of the actor's
    width (100) once and the generic one not at all; on the CPU none."""
    from code_robchar_tpu_torch.models import PPO_en

    def one(device):
        p = PPO_en(4, 0, 2, testing=True, num_agents=16, seed=3,
                   ham_noisy=True, device=device)
        fn = p._build_epoch(16, 0.2, 3e-3, 1e-3, 1000, 3, 3, 0.01)
        return fn(p._init_agent(prng.split(prng.key(1), 16)))

    def counts():
        return _count("actor_env_rollout_reg", "actor_env_rollout",
                      "critic_train_bf16", "critic_train")

    before = counts()
    (_, got), (_, want) = one(dev), one("cpu")
    assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
    err = (got.rewards.cpu() - want.rewards).abs().amax(1)
    assert int((err <= 1e-4).sum()) >= 15, err


@pytest.mark.parametrize("streams", [1, 4, 8])
def test_alu_probe_kernel_equals_plain_version(dev, streams):
    from code_robchar_tpu_torch.ops import probes

    x = torch.as_tensor(probes.reference_alu_input(5000), device=dev)
    before = build.LAUNCHES["alu_probe"]
    got = probes.alu_probe(x, streams, 256)      # ragged last block
    want = probes.alu_probe_plain(x, streams, 256)
    torch.cuda.synchronize()
    assert build.LAUNCHES["alu_probe"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["mul", "tanh", "rational"])
def test_tanh_probe_kernel_equals_plain_version(dev, op):
    from code_robchar_tpu_torch.ops import probes

    x = prng.normal(prng.key(0), (37, 100), torch.float32).to(dev)
    before = build.LAUNCHES["tanh_probe"]
    got = probes.tanh_probe(x, op, 300)
    want = probes.tanh_probe_plain(x, op, 300)
    torch.cuda.synchronize()
    assert build.LAUNCHES["tanh_probe"] == before + 1 and got.shape == x.shape
    if op == "tanh":        # tanhf against torch.tanh
        assert float((got - want).abs().max()) <= 300 * 2.0 ** -24
    else:
        assert torch.equal(got, want)


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    from code_robchar_tpu_torch.ops import probes

    x = torch.ones((10, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):
        probes.alu_probe(x.double(), 4, 8)
    with pytest.raises(ValueError):
        probes.alu_probe(x, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        probes.tanh_probe(x.t(), "mul", 8)


@pytest.mark.parametrize("form", ["one key", "batch of keys"])
def test_binomial_on_card_matches_cpu(dev, form):
    """Both samplers (counts 10 and 1000 over p in [0, 1]) on the card
    against the CPU: the words and uniforms are equal; a count may differ
    where the two devices' log differ by an ulp across a bound."""
    rng = np.random.default_rng(3)
    size = 1 << 16
    p = torch.as_tensor(rng.uniform(0, 1, size).astype(np.float32))
    count = torch.as_tensor(rng.choice([10.0, 1000.0], size)
                            .astype(np.float32))
    key = prng.key(2) if form == "one key" else prng.split(prng.key(2), size)
    got = prng.binomial(key.to(dev), count.to(dev), p.to(dev)).cpu()
    want = prng.binomial(key, count, p)
    assert float((got != want).double().mean()) <= 1e-3


def test_env_on_card_takes_the_amplitude_kernel(dev):
    """Env.true_fid, env_step (noisy, noiseless and the fixed ensemble) on
    the card launch the lane-group amplitude kernel and agree with the CPU
    plain version (cyclic order) within the kernel bar."""
    from code_robchar_tpu_torch.models import env

    kw = dict(ham_noisy=True, seed=4, dtype=torch.float32)
    card = env.Environment(5, 0, 4, device=dev, **kw)
    cpu = env.Environment(5, 0, 4, device="cpu", **kw)
    action = np.diag(np.random.default_rng(0).uniform(-3, 3, 5))
    before = build.LAUNCHES["sym_jacobi_amp_group"]
    got = card.true_fid(action, 7.5)
    assert build.LAUNCHES["sym_jacobi_amp_group"] == before + 1
    assert abs(got - cpu.true_fid(action, 7.5)) <= 3e-5
    card.timestep = cpu.timestep = 2.0
    before = build.LAUNCHES["sym_jacobi_amp_group"]
    (_, r_card, _), (_, r_cpu, _) = card.step(action), cpu.step(action)
    # the noisy reward and the true fidelity: two launches
    assert build.LAUNCHES["sym_jacobi_amp_group"] == before + 2
    assert abs(r_card - r_cpu) <= 3e-5 and abs(card.tf - cpu.tf) <= 3e-5
    fixed = env.Environment(4, 0, 3, device=dev, use_fixed_ham=True,
                            opt_train_size=6, dtype=torch.float32)
    before = build.LAUNCHES["sym_jacobi_amp_group"]
    reward = fixed.fidelity()
    assert build.LAUNCHES["sym_jacobi_amp_group"] == before + 2
    assert 0.0 <= reward <= 1.0 + 1e-5


def test_single_point_objectives_on_card_match_cpu(dev):
    """make_infidelity (ham_noisy), make_exact_gradient and make_wass_cost
    at N=5 on 64 points with fixed keys: the card's kernels against the
    CPU plain versions on the same keys, one launch a call."""
    from code_robchar_tpu_torch.models import objectives

    n = 5
    rng = np.random.default_rng(3)
    xs = np.column_stack([rng.uniform(-3, 3, (64, n)),
                          rng.uniform(0.5, 6, 64)])
    keys = prng.split(prng.key(5), 64)

    def spec(device):
        return objectives.ObjectiveSpec(
            h0=chain.xx_hamiltonian_real(n, device=device), in_spin=0,
            out_spin=n - 1, noise=0.05, fid_noisy=False, ham_noisy=True,
            draws=10, adaptive=False, adp_tol=0.05, fixed_hams=None,
            mul_fac=1)

    x_card = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    x_cpu = x_card.cpu()
    amp0, grad0 = _sym_launches()
    f_card, _ = objectives.make_infidelity(spec(dev))(x_card, keys)
    assert _sym_launches()[0] == amp0 + 1
    f_cpu, _ = objectives.make_infidelity(spec("cpu"))(x_cpu, keys)
    assert float((f_card.cpu() - f_cpu).abs().max()) <= 3e-5
    e_card, g_card = objectives.make_exact_gradient(spec(dev))(x_card)
    assert _sym_launches()[1] == grad0 + 1
    e_cpu, g_cpu = objectives.make_exact_gradient(spec("cpu"))(x_cpu)
    assert float((g_card.cpu() - g_cpu).abs().max()) <= 1e-4
    w_card = objectives.make_wass_cost(spec(dev), 5)(x_card, keys)
    assert _sym_launches()[0] == amp0 + 2
    w_cpu = objectives.make_wass_cost(spec("cpu"), 5)(x_cpu, keys)
    assert float((w_card.cpu() - w_cpu).abs().max()) <= 3e-5


def test_base_helpers_run_on_the_optimizers_device(dev):
    """overlap_ss and directional_perturbation of an optimizer on the card
    compute there, and agree with the CPU optimizer of the same seed."""
    from code_robchar_tpu_torch.models import NMPlus

    kw = dict(testing=True, seed=6, noise=0.3, dtype=torch.float32)
    card, cpu = NMPlus(5, 0, 4, device=dev, **kw), \
        NMPlus(5, 0, 4, device="cpu", **kw)
    x = np.random.default_rng(2).uniform(-1, 1, 6)
    assert abs(card.overlap_ss(x) - cpu.overlap_ss(x)) <= 1e-5
    for _ in range(6):
        z = card.directional_perturbation()
        assert z.device.type == "cuda"
        want = cpu.directional_perturbation()
        assert torch.equal(z.cpu() != 0, want != 0)
        torch.testing.assert_close(z.cpu(), want, rtol=1e-6, atol=1e-7)
