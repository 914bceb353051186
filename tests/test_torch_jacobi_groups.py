"""The lane-group Jacobi kernels' tables and routes, on the CPU.

The kernels (csrc/jacobi_common.cuh ``group_sweeps``, sym_jacobi_amp.cu,
sym_jacobi_grad.cu) run only on a card (tests/test_torch_cuda.py).  What
they deal over a group's lanes at compile time — a stage's pivots, V's
rows, the pairs of the Daleckii-Krein contraction — is mirrored by
``realform.group_layout`` and held here against ``realform.pair_schedule``,
together with the route functions of
ops/cuda_jacobi.py, the wrappers' refusals and the instrumenter of
tools/profile_jacobi.py on the sources as they stand.
"""

import importlib.util
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import LBFGS, NMPlus, PPO_en
from code_robchar_tpu_torch.ops import chain, cuda_jacobi, prng, realform
from code_robchar_tpu_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "code_robchar_tpu_torch", "csrc")
SIZES = range(2, 11)


@pytest.mark.parametrize("n", SIZES)
def test_stages_cover_every_pivot_once_and_follow_the_schedule(n):
    lay = realform.group_layout(n)
    m = n + n % 2
    lanes = min(realform.GROUP_LANES, m // 2)
    assert lay["lanes"] == lanes and lay["per_warp"] == 32 // lanes
    assert len(lay["stages"]) == m - 1
    assert all(len(stage) == m // 2 for stage in lay["stages"])
    # every slot's angles are computed by one lane, in one of its
    # ceil(slots / lanes) registers
    assert len(set(lay["slot_lanes"])) == m // 2
    assert all(0 <= lane < lanes and 0 <= reg < -(-(m // 2) // lanes)
               for lane, reg in lay["slot_lanes"])
    # slot order within a stage and stage order within a sweep are those
    # of the plain version's schedule; byes are the only gaps
    assert [[p for p in stage if p is not None] for stage in lay["stages"]] \
        == realform.pair_schedule(n)
    pivots = [p for stage in lay["stages"] for p in stage if p is not None]
    assert sorted(pivots) == [(p, q) for p in range(n)
                              for q in range(p + 1, n)]
    for stage in lay["stages"]:
        touched = [i for p in stage if p is not None for i in p]
        assert len(touched) == len(set(touched))        # disjoint pivots
        assert sum(p is None for p in stage) == n % 2   # one bye when odd


@pytest.mark.parametrize("n", SIZES)
def test_rows_and_pairs_are_dealt_once_each(n):
    lay = realform.group_layout(n)
    g = lay["lanes"]
    rows_per_lane = -(-n // g)
    assert len(set(lay["rows"])) == n
    assert all(0 <= lane < g and 0 <= reg < rows_per_lane
               for lane, reg in lay["rows"])
    assert [lane + g * reg for lane, reg in lay["rows"]] == list(range(n))
    pairs = lay["pairs"]
    assert pairs == [(j, k) for j in range(n) for k in range(j, n)]
    assert len(pairs) == n * (n + 1) // 2 == len(set(lay["pair_lanes"]))
    pairs_per_lane = -(-len(pairs) // g)
    assert all(0 <= lane < g and 0 <= reg < pairs_per_lane
               for lane, reg in lay["pair_lanes"])
    # the kernels' closed form of the row-major list: pair q starts row j
    # after n + (n - 1) + ... + (n - j + 1) entries
    for q, (j, k) in enumerate(pairs):
        assert q == j * n - j * (j - 1) // 2 + (k - j)


@pytest.mark.parametrize("n,lanes", [(2, 1), (3, 2), (4, 2), (5, 3), (6, 3),
                                     (7, 4), (8, 4), (9, 4), (10, 4)])
def test_group_width_per_size(n, lanes):
    """One lane per slot of a stage up to GROUP_LANES; from there on a lane
    takes the slots, rows and pairs k, k + L, ..."""
    lay = realform.group_layout(n)
    assert realform.GROUP_LANES == 4
    assert lay["lanes"] == lanes and lay["per_warp"] == 32 // lanes
    assert lay["slot_lanes"] == [(k % lanes, k // lanes)
                                 for k in range((n + 1) // 2)]
    assert lay["rows"][:lanes] == [(k, 0) for k in range(lanes)]
    if n > lanes:
        assert lay["rows"][lanes] == (0, 1)
    assert lay["pair_lanes"][lanes] == (0, 1)


@pytest.mark.parametrize("path,kind,n,b,kernel", [
    ("L-BFGS lanes", "grad", 7, 1024, "sym_jacobi_grad_group"),
    ("NM round", "amp", 7, 9216, "sym_jacobi_amp_group"),
    ("a batch of the lanes' width", "amp", 7, 1024, "sym_jacobi_amp_group"),
    ("PPO true fidelities", "amp", 7, 512_000, "sym_jacobi_amp"),
    ("wide L-BFGS lanes", "grad", 7, 131_072, "sym_jacobi_grad"),
    ("a batch that fills the card", "amp", 7, 65_536, "sym_jacobi_amp"),
    ("two-spin chain", "amp", 2, 64, "sym_jacobi_amp"),
    ("two-spin chain", "grad", 2, 64, "sym_jacobi_grad"),
])
def test_paths_take_the_route_of_their_shape(path, kind, n, b, kernel):
    route = cuda_jacobi.amp_route if kind == "amp" else cuda_jacobi.grad_route
    assert route(n, b) == kernel, path


def test_routes_at_their_boundaries():
    amp_max, grad_max = (cuda_jacobi.AMP_GROUP_MAX_B,
                         cuda_jacobi.GRAD_GROUP_MAX_B)
    assert cuda_jacobi.GROUP_MIN_N == 3
    for n in range(3, 11):
        assert cuda_jacobi.amp_route(n, 1) == "sym_jacobi_amp_group"
        assert cuda_jacobi.amp_route(n, amp_max) == "sym_jacobi_amp_group"
        assert cuda_jacobi.amp_route(n, amp_max + 1) == "sym_jacobi_amp"
        assert cuda_jacobi.grad_route(n, grad_max) == "sym_jacobi_grad_group"
        assert cuda_jacobi.grad_route(n, grad_max + 1) == "sym_jacobi_grad"
    # one pivot a stage: a group would be one lane
    assert cuda_jacobi.amp_route(2, 1) == "sym_jacobi_amp"
    assert cuda_jacobi.grad_route(2, 1) == "sym_jacobi_grad"
    # both sweeps of tools/profile_jacobi.py agree up to these batches
    assert (amp_max, grad_max) == (16384, 24576)


@pytest.mark.parametrize("kernel", ["sym_jacobi_amp", "sym_jacobi_amp_group",
                                    "sym_jacobi_grad",
                                    "sym_jacobi_grad_group"])
def test_named_kernels_refuse_cpu_tensors_and_count_nothing(kernel,
                                                            monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    monkeypatch.setattr(build, "load", None)          # never reached
    with pytest.raises(ValueError, match="CUDA device"):
        if "amp" in kernel:
            cuda_jacobi.transfer_amp_sym_kernel(
                kernel, torch.zeros(4, 4, 8), torch.zeros(8), 0, 3)
        else:
            cuda_jacobi.infidelity_and_gradient_sym_kernel(
                kernel, torch.zeros(4, 4), torch.zeros(8, 5), 0, 3)
    assert not build.LAUNCHES


def test_route_check_refuses_unknown_names_and_n2_groups():
    amps = ("sym_jacobi_amp", "sym_jacobi_amp_group")
    cuda_jacobi._check_route("sym_jacobi_amp", amps, 2)
    cuda_jacobi._check_route("sym_jacobi_amp_group", amps, 3)
    with pytest.raises(ValueError, match="3..10"):
        cuda_jacobi._check_route("sym_jacobi_amp_group", amps, 2)
    with pytest.raises(ValueError, match="unknown kernel"):
        cuda_jacobi._check_route("sym_jacobi_grad", amps, 7)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.launch_floor("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.angles_probe(torch.zeros(3, 8))


def test_dispatch_on_cpu_tensors_is_plain_and_counts_nothing(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    rng = np.random.default_rng(3)
    n, b = 7, 12
    a = rng.normal(size=(n, n, b))
    a = torch.as_tensor((a + a.transpose(1, 0, 2)) / 2)
    t = torch.as_tensor(rng.uniform(1, 5, b))
    got = cuda_jacobi.transfer_amp_sym(a, t, 0, n - 1)
    want = realform.transfer_amp_sym_lanes(a, t, 0, n - 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not build.LAUNCHES


@pytest.mark.parametrize("entry", ["resolver", "engine", "lbfgs", "nmplus",
                                   "ppo"])
def test_no_device_means_the_card_and_raises_without_one(entry):
    """``device=None`` is the card at every entry point: without one it
    raises as an explicit "cuda" does; the CPU is taken only on request."""
    if torch.cuda.is_available():
        pytest.skip("this checks a machine without CUDA")
    calls = {
        "resolver": lambda **kw: config.resolve_device(kw.get("device")),
        "engine": lambda **kw: engine.mc_fidelity_sweep(
            chain.xx_hamiltonian_real(3), np.zeros((2, 4), np.float32),
            np.zeros(1, np.float32), prng.key(0), 2, 0, 2, **kw),
        "lbfgs": lambda **kw: LBFGS(3, 0, 2, testing=True, **kw),
        "nmplus": lambda **kw: NMPlus(3, 0, 2, testing=True, **kw),
        "ppo": lambda **kw: PPO_en(3, 0, 2, testing=True, num_agents=2,
                                   **kw),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    calls[entry](device="cpu")


def _profile_tool():
    spec = importlib.util.spec_from_file_location(
        "profile_jacobi", os.path.join(REPO, "tools", "profile_jacobi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_tool_instruments_the_sources_as_they_stand():
    """Every ``// @phase`` marker of the three sources names a phase the
    tool knows and becomes a clock reading; each kernel source declares its
    state once per route and ends each kernel with the ``store`` marker
    that writes the readings out."""
    tool = _profile_tool()
    with open(os.path.join(CSRC, "jacobi_common.cuh")) as f:
        header = f.read()
    out = tool.instrument_header(header)
    assert "@phase" not in out.split("#pragma once")[1]
    # the one-thread hoisted sweep adds a reading of its own (angles)
    assert out.count("JPROF(") == 1 + 3 and out.count("JPROF_ST(") == 1 + 3
    assert "long long pacc[JPROF_PHASES];" in out
    for kind, epilogues in (("amp", 1), ("grad", 2)):
        with open(os.path.join(CSRC, f"sym_jacobi_{kind}.cu")) as f:
            src = f.read()
        names = re.findall(r"// @phase\(st\) (.*)$", src, flags=re.M)
        assert set(names) <= set(tool.PHASES)
        assert len(names) == 2 * (2 + epilogues)
        out = tool.instrument_kernel(src)
        assert not re.search(r"^\s*// @phase", out, flags=re.M)
        assert out.count("jprof_begin(st);") == 2
        assert out.count("jprof_end(st);") == 2
        assert 'extern "C" int jprof_read' in out


def test_sources_state_the_group_width_the_mirror_uses():
    """The kernels ask for GROUP_LANES lanes a matrix, at most M / 2, of a
    32-lane warp in 32-thread blocks, as ``group_layout`` mirrors it, and
    the group entries are built for n = 3..10."""
    with open(os.path.join(CSRC, "jacobi_common.cuh")) as f:
        header = f.read()
    assert "static constexpr int kSlots = M / 2;" in header
    assert (f"constexpr int kGroupLanes = {realform.GROUP_LANES};"
            in header)
    assert "return kGroupLanes < Schedule<N>::kSlots ? kGroupLanes" in header
    assert "static constexpr int kPerWarp = 32 / L;" in header
    assert "constexpr int kGroupThreads = 32;" in header
    for kind in ("amp", "grad"):
        with open(os.path.join(CSRC, f"sym_jacobi_{kind}.cu")) as f:
            src = f.read()
        assert src.count("jacobi::group_lanes<N>()") == 2
        cases = [int(x) for x in re.findall(r"case (\d+): return "
                                            r"launch_group<", src)]
        assert cases == list(range(cuda_jacobi.GROUP_MIN_N,
                                   cuda_jacobi.MAX_N + 1))
