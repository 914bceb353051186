"""The MC sweep's chunk draws (code_robchar_tpu_torch/ops/mc_draws.py) on
the CPU: the plain route against the composition it replaces in the
engine, ``prng.fold_in`` of the global ids written out element by element
and ``noise.assemble_lanes``, bit for bit; the checks that refuse what no
route takes; and the engine's fused and unfused sweeps, which now draw
through it.  The kernel route is held on the card in
tests/test_torch_cuda.py."""

from collections import Counter

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.ops import chain, mc_draws, noise
from code_robchar_tpu_torch.ops import prng
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


def _inputs(n, num_l, num_c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    h0 = torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype)
    ctrl = torch.as_tensor(np.column_stack([rng.uniform(-10, 10, (num_c, n)),
                                            rng.uniform(-30, 30, num_c)]),
                           dtype=dtype)
    noises = torch.as_tensor(np.linspace(0, 0.1, num_l), dtype=dtype)
    return h0, ctrl, noises


def _composition(h0, ctrl, noises, key, start, count, bootreps, cx,
                 c_offset, c_global):
    """The engine's draws before the kernel: the global id of every local
    element (l, c, b) of the (L, C, bootreps) block, fold_in, then
    assemble_lanes of its controller row and noise level."""
    num_c = ctrl.shape[0]
    rows = []
    for i in range(start, start + count):
        cell, b = divmod(i, bootreps)
        l, c = divmod(cell, num_c)
        rows.append((l, c, (l * c_global + c + c_offset) * bootreps + b))
    l_idx, c_idx, gids = (torch.tensor(v, dtype=torch.int64)
                          for v in zip(*rows))
    return noise.assemble_lanes(h0, ctrl[c_idx], noises[l_idx],
                                prng.fold_in(key, gids), cx)


def _bits(x):
    """The values' bit patterns (tells -0.0 from 0.0)."""
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


#: (n, L, C, bootreps, start, count, c_offset, c_global): a whole small
#: lattice, a chunk that starts mid-lattice, the partial last chunk, mesh
#: blocks (c_offset > 0, c_global > C), ids past 2^32 / bootreps cells
CASES = [
    (5, 3, 4, 10, 0, 120, 0, None),
    (7, 11, 6, 100, 1_234, 3_000, 0, None),
    (7, 11, 6, 100, 6_600 - 77, 77, 0, None),
    (5, 2, 3, 7, 5, 30, 4, 10),
    (7, 3, 5, 9, 11, 100, 15, 20),
    (2, 1, 2, 3, 0, 6, 0, None),
    (3, 2, 4, 5, 3, 20, 2**31, 2**31 + 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cx", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_route_equals_fold_in_and_assemble_lanes(case, cx, dtype):
    n, num_l, num_c, reps, start, count, c_offset, c_global = case
    h0, ctrl, noises = _inputs(n, num_l, num_c, dtype, seed=n + count)
    key = prng.fold_in(prng.key(2**40 + 17), 5)
    got = mc_draws.draw_lanes(h0, ctrl, noises, key, start, count, reps, cx,
                              c_offset, c_global)
    want = _composition(h0, ctrl, noises, key, start, count, reps, cx,
                        c_offset, ctrl.shape[0] if c_global is None
                        else c_global)
    assert [g.shape for g in got] == [(n, n, count), (n, n, count), (count,)]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(_bits(g), _bits(w))


def test_a_block_draws_what_the_whole_lattice_draws():
    """Controllers 2..4 of 6 as a block (c_offset 2, c_global 6) draw the
    matrices of those controllers in the whole lattice."""
    n, num_l, reps = 4, 3, 5
    h0, ctrl, noises = _inputs(n, num_l, 6, torch.float32, seed=3)
    key = prng.key(11)
    whole = mc_draws.draw_lanes(h0, ctrl, noises, key, 0, num_l * 6 * reps,
                                reps)
    block = mc_draws.draw_lanes(h0, ctrl[2:5], noises, key, 0,
                                num_l * 3 * reps, reps, True, 2, 6)
    for w, b in zip(whole, block):
        w = w.reshape(w.shape[:-1] + (num_l, 6, reps))[..., 2:5, :]
        assert torch.equal(w.reshape(b.shape), b)


def _bad(kind):
    h0, ctrl, noises = _inputs(4, 2, 3, torch.float32)
    key = prng.key(1)
    args = dict(h0r=h0, ctrl=ctrl, noises=noises, key=key, start=0, count=6,
                bootreps=5, c_offset=0, c_global=None)
    change = {
        "h0_not_square": dict(h0r=h0[:, :3]),
        "h0_batched": dict(h0r=h0[None]),
        "n1": dict(h0r=h0[:1, :1], ctrl=ctrl[:, :2]),
        "ctrl_width": dict(ctrl=ctrl[:, :4]),
        "noises_2d": dict(noises=noises[:, None]),
        "key_batch": dict(key=prng.split(key, 2)),
        "key_int32": dict(key=key.to(torch.int32)),
        "ctrl_float64": dict(ctrl=ctrl.double()),
        "all_float16": dict(h0r=h0.half(), ctrl=ctrl.half(),
                            noises=noises.half()),
        "ids_past_lattice": dict(start=25, count=6),
        "negative_start": dict(start=-1),
        "zero_bootreps": dict(bootreps=0),
        "block_past_c_global": dict(c_offset=1, c_global=3),
        "negative_offset": dict(c_offset=-1, c_global=3),
    }[kind]
    return args, dict(args, **change)


BAD = ["h0_not_square", "h0_batched", "n1", "ctrl_width", "noises_2d",
       "key_batch", "key_int32", "ctrl_float64", "all_float16",
       "ids_past_lattice", "negative_start", "zero_bootreps",
       "block_past_c_global", "negative_offset"]


@pytest.mark.parametrize("kind", BAD)
def test_draws_refuse_what_no_route_takes(kind):
    good, bad = _bad(kind)
    mc_draws.draw_lanes(**good)                  # the good case passes
    with pytest.raises(ValueError):
        mc_draws.draw_lanes(**bad)


def test_kernel_route_refuses_cpu_tensors(monkeypatch):
    """The kernel's wrapper refuses CPU tensors without building or
    launching anything."""
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    monkeypatch.setattr(build, "load", None)          # never reached
    h0, ctrl, noises = _inputs(4, 2, 3, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        mc_draws.draw_lanes_cuda(h0, ctrl, noises, prng.key(1), 0, 6, 5)
    assert not build.LAUNCHES


@pytest.mark.parametrize("bad", ["float64", "ctrl_noncontiguous",
                                 "key_noncontiguous", "n11"])
def test_kernel_input_checks(bad):
    """What the kernel does not take is refused before any launch, each
    fault by its own message ahead of the device check (the checks run
    here on CPU tensors, which the good case fails on alone)."""
    h0, ctrl, noises = _inputs(4, 2, 3, torch.float32)
    key = prng.key(1)
    with pytest.raises(ValueError, match="CUDA device"):
        mc_draws._check_kernel(h0, ctrl, noises, key)
    if bad == "float64":
        h0, ctrl, noises = (x.double() for x in (h0, ctrl, noises))
        match = "float32 only"
    elif bad == "ctrl_noncontiguous":
        ctrl = ctrl.T.contiguous().T
        match = "ctrl must be contiguous"
    elif bad == "key_noncontiguous":
        key = torch.zeros((2, 2), dtype=torch.int64)[:, 0]
        match = "key must be contiguous"
    else:
        h0, ctrl, noises = _inputs(11, 2, 3, torch.float32)
        match = "n=11"
    with pytest.raises(ValueError, match=match):
        mc_draws._check_kernel(h0, ctrl, noises, key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [None, 37])
def test_metric_sweep_equals_metrics_of_the_fidelity_sweep(dtype, chunk,
                                                          monkeypatch):
    """The fused sweep still equals metric_tensors of the unfused one on
    the CPU, and the CPU route launches nothing."""
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    n = 4
    h0 = chain.xx_hamiltonian_real(n, dtype=dtype)
    _, ctrl, noises = _inputs(n, 3, 5, dtype, seed=9)
    key = prng.key(7)
    kw = dict(complex_offdiag=True, chunk=chunk, device="cpu")
    fused = engine.mc_metric_sweep(h0, ctrl, noises, key, 16, 0, n - 1, **kw)
    fids = engine.mc_fidelity_sweep(h0, ctrl, noises, key, 16, 0, n - 1,
                                    **kw)
    want = engine.metric_tensors(fids)
    assert sorted(fused) == sorted(want)
    for name in want:
        assert torch.allclose(fused[name], want[name], rtol=0,
                              atol=1e-12 if dtype == torch.float64 else 1e-6)
    assert not build.LAUNCHES


def test_fidelity_sweep_draws_each_chunk_once(monkeypatch):
    """Each chunk's draws are one call, (start, count) tiling the lattice:
    no element is drawn twice or left out."""
    calls = []
    draw = mc_draws.draw_lanes

    def record(*args):
        calls.append(args[4:6])
        return draw(*args)

    monkeypatch.setattr(mc_draws, "draw_lanes", record)
    n = 3
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float64)
    _, ctrl, noises = _inputs(n, 2, 3, torch.float64)
    engine.mc_fidelity_sweep(h0, ctrl, noises, prng.key(2), 10, 0, n - 1,
                             chunk=25, device="cpu")
    assert calls == [(0, 25), (25, 25), (50, 10)]
