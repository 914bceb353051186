"""What the stage-hoisted Jacobi sweeps and the register-resident rollout
kernel rest on, on the CPU.

- Hoisting changes no bit.  The one-thread kernels of the MC path
  (csrc/herm_jacobi_fidelity.cu) and of the rollout's fidelities compute a
  round-robin stage's angles from the state at the start of the stage
  (csrc/jacobi_common.cuh ``hoisted_sweeps``).  The plain versions do the
  same; written out here with each pivot's angles taken right before its
  rotation, they must give the same float32 results bit for bit, since a
  stage's pivots are disjoint.
- The rollout's launch layout: which of the two kernels of
  csrc/actor_env_rollout.cu a width takes (the register-resident one at the
  path's width, through its own C entry; the generic one at the others),
  and ``rollout.smem_bytes`` of each, against the constants of the
  source.
- The instrumenters of tools/profile_jacobi.py (``--herm``) and
  tools/profile_rollout.py on the ``// @phase`` and ``// @fallback`` lines of
  the sources as they stand.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.ops import realform, rollout
from code_robchar_tpu_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "code_robchar_tpu_torch", "csrc")
SIZES = range(2, 11)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spins(n):
    return [(0, n - 1), (1, min(2, n - 1))]


def _herm(n, b, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, b))
    z = rng.normal(size=(n, n, b))
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (
        (a + a.transpose(1, 0, 2)) / 2, (z - z.transpose(1, 0, 2)) / 2,
        rng.uniform(1, 30, b)))


def _rows(n, p, q):
    return torch.tensor([i for i in range(n) if i not in (p, q)],
                        dtype=torch.long)


def _herm_per_pivot(ar, ai, t, i, o):
    """fidelity_herm_lanes with each pivot's angles computed right before
    its rotation."""
    n, b = ar.shape[0], ar.shape[-1]
    eps = realform._eps_for(ar.dtype)
    ar, ai = ar.clone(), ai.clone()
    vr = torch.zeros((2, n, b))
    vr[0, i] = 1.0
    vr[1, o] = 1.0
    vi = torch.zeros_like(vr)
    for _ in range(realform._sweeps_for(ar.dtype, n)):
        for stage in realform.pair_schedule(n):
            for p, q in stage:
                realform._apply(ar, ai, vr, vi, p, q, _rows(n, p, q),
                                realform._angles(ar, ai, p, q, eps))
    phr = torch.zeros_like(t)
    phi = torch.zeros_like(t)
    for k in range(n):
        gr = vr[1, k] * vr[0, k] + vi[1, k] * vi[0, k]
        gi = vi[1, k] * vr[0, k] - vr[1, k] * vi[0, k]
        ang = ar[k, k] * t
        fr, fi = torch.cos(ang), -torch.sin(ang)
        phr = phr + gr * fr - gi * fi
        phi = phi + gr * fi + gi * fr
    return phr * phr + phi * phi


def _sym_per_pivot(a, t, i, o):
    """transfer_amp_sym_lanes with each pivot's angles computed right
    before its rotation."""
    n, b = a.shape[0], a.shape[-1]
    eps = realform._eps_for(a.dtype)
    a = a.clone()
    v = torch.zeros((2, n, b))
    v[0, i] = 1.0
    v[1, o] = 1.0
    for _ in range(realform._sweeps_for(a.dtype, n)):
        for stage in realform.pair_schedule(n):
            for p, q in stage:
                realform._sym_apply(a, v, p, q,
                                    realform._sym_angles(a, p, q, eps))
    phr = torch.zeros_like(t)
    phi = torch.zeros_like(t)
    for k in range(n):
        w = v[0, k] * v[1, k]
        ang = a[k, k] * t
        phr = phr + w * torch.cos(ang)
        phi = phi - w * torch.sin(ang)
    return phr, phi


@pytest.mark.parametrize("n", SIZES)
def test_hoisting_a_stages_hermitian_angles_changes_no_bit(n):
    ar, ai, t = _herm(n, 96, seed=n)
    for i, o in _spins(n):
        hoisted = realform.fidelity_herm_lanes(ar, ai, t, i, o,
                                               order="roundrobin")
        assert torch.equal(hoisted, _herm_per_pivot(ar, ai, t, i, o))


@pytest.mark.parametrize("n", SIZES)
def test_hoisting_a_stages_symmetric_angles_changes_no_bit(n):
    ar, _, t = _herm(n, 96, seed=100 + n)
    # the rollout's matrices: a chain with biases, some degenerate
    ar[:, :, :8] = 0.0
    for i, o in _spins(n):
        hoisted = realform.transfer_amp_sym_lanes(ar, t, i, o,
                                                  order="roundrobin")
        per_pivot = _sym_per_pivot(ar, t, i, o)
        assert torch.equal(hoisted[0], per_pivot[0])
        assert torch.equal(hoisted[1], per_pivot[1])


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_rollout_constants_are_the_kernels():
    """The width that takes the register-resident kernel is the source's,
    each kernel has its C entry, the one ops/rollout.py calls, and the
    register-resident one refuses any other width."""
    src = _source("actor_env_rollout.cu")
    assert _constant(src, "kRegHidden") == rollout.REG_HIDDEN
    assert "ROLLOUT_ENTRY(actor_env_rollout, false)" in src
    assert "ROLLOUT_ENTRY(actor_env_rollout_reg, true)" in src
    assert "if (sc.h != kRegHidden) return cudaErrorInvalidValue;" in src
    assert "__launch_bounds__(kRegThreads, kRegBlocksPerSm)" in src
    assert "constexpr int kMaxSlots = 16;" in src
    assert "__shared__ float s_part[W][kMaxSlots];" in src
    with open(rollout.__file__) as f:
        wrapper = f.read()
    assert ('_ENTRIES = {True: build.kernel("actor_env_rollout_reg", *_ARGS),\n'
            '            False: build.kernel("actor_env_rollout", *_ARGS)}'
            in wrapper)
    assert "_ENTRIES[hid == REG_HIDDEN](" in wrapper


@pytest.mark.parametrize("n", [2, 7, 10])
def test_rollout_launch_shape_of_the_path_width(n):
    d = n + 1
    hid = rollout.REG_HIDDEN
    src = _source("actor_env_rollout.cu")
    smem = rollout.smem_bytes(n, hid)
    # h1, W1, four warps' 16 slots of layer 3 and h0; W2 and W3 live in
    # registers, so the blocks the registers allow fit by shared memory too,
    # in the static 48 KB of a block
    assert smem == 4 * (hid + (d + 1) * hid + 4 * 16 + n * n)
    assert _constant(src, "kRegThreads") == 4 * 32
    assert _constant(src, "kRegBlocksPerSm") * smem < build.SMEM_PER_BLOCK
    assert smem <= 48 * 1024
    assert rollout.smem_bytes(7, 100) == 4452


@pytest.mark.parametrize("n,hid", [(7, 64), (4, 16), (10, 40), (7, 160),
                                   (3, 300)])
def test_rollout_launch_shape_of_the_generic_instance(n, hid):
    d = n + 1
    assert hid != rollout.REG_HIDDEN
    assert rollout.smem_bytes(n, hid) == 4 * (
        (d + 1) * hid + (hid + 1) * hid + (hid + 1) * d + 2 * hid
        + 3 * d + n * n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_tool_instruments_the_hermitian_kernel():
    """Every ``// @phase`` marker of the Hermitian kernel names a phase the
    tool knows and becomes a clock reading; the state gains its sums; the
    header's exact-angle branch becomes a count."""
    tool = _tool("profile_jacobi")
    src = _source("herm_jacobi_fidelity.cu")
    names = re.findall(r"// @phase(?:\(st\))? (.*)$", src, flags=re.M)
    assert set(names) <= set(tool.PHASES) and len(names) == 5
    out = tool.instrument_herm(src)
    assert not re.search(r"^\s*// @phase", out, flags=re.M)
    assert out.count("jprof_begin(st);") == 1
    assert out.count("jprof_end(st);") == 1
    assert "long long pacc[JPROF_PHASES];" in out
    assert 'extern "C" int jprof_exact' in out
    header = tool.instrument_header(_source("jacobi_common.cuh"))
    assert header.count("atomicAdd(&g_exact[0], 1ull)") == 1
    assert "// @fallback" not in header


def test_profile_tool_instruments_the_rollout_kernel():
    """Both instances of the rollout kernel start their sums and write them
    out after their Jacobi phase; every marker names a known phase."""
    tool = _tool("profile_rollout")
    src = _source("actor_env_rollout.cu")
    names = re.findall(r"// @phase (.*)$", src, flags=re.M)
    assert set(names) == set(tool.PHASES)
    out = tool.instrument(src)
    assert not re.search(r"^\s*// @phase", out, flags=re.M)
    assert out.count("long long plast = clock64();") == 2
    assert out.count("g_prof[i_] = pacc[i_];") == 2
    assert out.count("JPROF(") == len(names) + 1
    assert 'extern "C" int jprof_read' in out
