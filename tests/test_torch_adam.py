"""The port's Adam (code_robchar_tpu_torch/models/adam.py) and the run
loop's persistent streams and per-iteration candidates
(models/base.py) against the JAX package, on the CPU at N=4.

- Segments at float64: a plain segment, a restart segment (the restart
  cadence moved to two segments in both modules, the gradient gate raised
  so that streams probe several times) and a plain one, noiseless and
  ham_noisy: the stream state (w, m, v) within 1e-10, the pointers, the
  iteration counts, nfev and nit equal, the fidelities and the top
  candidates within 1e-10.
- The Sobol restart table, its rolling refill and the pointer lift, row
  for row and pointer for pointer against the JAX package and against an
  independent replay of the Sobol stream (the port's versions of
  tests/test_models.py's window tests).
- Whole ``run()`` records (best_fid, func_calls, iterations, the top-c
  store, the checkpoints), noiseless and ham_noisy.
- Float32: the Adam step follows the reference's compiled form (a product
  with the reciprocal of a constant divisor, constants folded), bit for
  bit over 1000 steps; the restart candidates are the reference's float32
  arithmetic bit for bit; ties in the top-k keep the earlier step.
- The registry, the refusals, a segment on a CPU mesh and the missing CPU
  fallback.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_robchar_tpu.models import MODEL_REGISTRY as JREGISTRY
from code_robchar_tpu.models import Adam as JAdam
from code_robchar_tpu.models import adam as jadam, base as jbase
from code_robchar_tpu.models import objectives as jobj
from code_robchar_tpu.ops.sobol import SobolStream
from code_robchar_tpu_torch.models import MODEL_REGISTRY, SNOB, Adam
from code_robchar_tpu_torch.models import adam as tadam
from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.ops import prng
from code_robchar_tpu_torch.parallel import Mesh

F64 = dict(dtype=torch.float64, device="cpu")
F32 = dict(dtype=torch.float32, device="cpu")
K, SEG = 8, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch operations: one thread keeps the module's time on
    a loaded machine what it is on an idle one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fresh_programs(monkeypatch):
    """An empty JAX program cache for this test: the reference bakes
    ``grad_gate`` and the objectives into its cached segment programs."""
    monkeypatch.setattr(jbase, "_PROGRAM_CACHE", OrderedDict())


def _cadence(monkeypatch, every, **consts):
    for mod in (jadam, tadam):
        monkeypatch.setattr(mod, "_RESTART_EVERY", every)
        for name, value in consts.items():
            monkeypatch.setattr(mod, name, value)


def _pair(k=K, seg=SEG, n=4, out=2, dtype=F64, **kw):
    kw = dict(dict(repeats=10**9, fid_threshold=0.0, testing=True, seed=3,
                   run_until_told_to_stop=True,
                   run_until_completion_its=10**9,
                   landscape_exploration=True, save_topc=16,
                   restart_batch=k, segment_its=seg), **kw)
    return JAdam(n, 0, out, **kw), Adam(n, 0, out, **kw, **dtype)


def _keys(jopt, opt, k):
    return (jax.random.split(jopt.next_key(), k),
            prng.split(opt.next_key(), k))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=1e-10):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


# ----------------------------------------------------------- segments


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy"])
def test_adam_segments_match_jax_f64(monkeypatch, fresh_programs, regime):
    _cadence(monkeypatch, 2 * SEG)
    kw = dict(ham_noisy=True, noise=0.05) if regime == "ham_noisy" else {}
    jopt, opt = _pair(**kw)
    # a gate most Sobol points miss at N=4: several probe rounds a restart
    jopt.grad_gate = opt.grad_gate = 0.3
    x0 = jopt.init_points(K)
    np.testing.assert_array_equal(opt.init_points(K), x0)
    for seg in range(3):
        jk, tk = _keys(jopt, opt, K)
        want = jopt._run_batch(jnp.asarray(x0), jk)
        got = opt._run_batch(torch.as_tensor(x0), tk)
        for name in ("x", "fid", "true_fid", "cand_fid", "cand_x"):
            _close(getattr(got, name), getattr(want, name))
        np.testing.assert_array_equal(_np(got.nfev), _np(want.nfev))
        np.testing.assert_array_equal(_np(got.nit), _np(want.nit))
        for g, w in zip(opt._stream[:3], jopt._stream[:3]):
            _close(g, w)
        for g, w in zip(opt._stream[3:], jopt._stream[3:]):
            np.testing.assert_array_equal(_np(g), _np(w))
        if seg == 1:           # the restart: every stream probed, some often
            assert int(got.nfev.min()) > SEG and int(got.nfev.max()) > \
                SEG + 4 and opt.stats["probe_rounds"] > 4
            assert opt.stats["syncs"] == opt.stats["probe_rounds"] + 2
        else:
            assert bool((got.nfev == SEG).all())
            assert opt.stats["probe_rounds"] == 0


def test_adam_segment_ties_keep_the_earlier_step(monkeypatch,
                                                 fresh_programs):
    """A ranking objective that returns one value at every step: every
    step ties, so ``jax.lax.top_k`` picks the first steps; so must the
    port (``torch.topk`` promises no order)."""
    monkeypatch.setattr(jobj, "make_infidelity_batch", lambda spec: (
        lambda xs, key: (jnp.full(xs.shape[0], 0.25, xs.dtype),
                         jnp.ones(xs.shape[0], jnp.int32))))
    monkeypatch.setattr(objectives, "make_infidelity_batch", lambda spec: (
        lambda xs, key: (torch.full((xs.shape[0],), 0.25, dtype=xs.dtype),
                         torch.ones(xs.shape[0], dtype=torch.int32))))
    jopt, opt = _pair()
    x0 = jopt.init_points(K)
    opt.init_points(K)
    jk, tk = _keys(jopt, opt, K)
    want = jopt._run_batch(jnp.asarray(x0), jk)
    got = opt._run_batch(torch.as_tensor(x0), tk)
    _close(got.cand_x, want.cand_x)
    assert bool((got.cand_fid == 0.75).all())
    # the first steps, not the last: every stream still moves
    assert bool((got.cand_x[:, 0] - got.x).abs().amax(1).gt(1e-6).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_candidates_keep_the_earlier_step_on_ties_f32(seed):
    """The top-k helper against ``jax.lax.top_k`` on float32 fidelities
    with many ties (values on a grid of eight): the same values and the
    same steps, exactly."""
    rng = np.random.default_rng(seed)
    s, k, d = 200, 16, 5
    fis = (rng.integers(0, 8, (s, k)) / 8).astype(np.float32)
    ws = rng.standard_normal((s, k, d)).astype(np.float32)
    cf, ci = jax.lax.top_k(jnp.asarray(fis).T, 4)
    want_x = np.take_along_axis(np.moveaxis(ws, 0, 1),
                                np.asarray(ci)[:, :, None], axis=1)
    got_f, got_x = tadam.top_candidates(torch.as_tensor(fis),
                                        torch.as_tensor(ws), 4)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(cf))
    np.testing.assert_array_equal(got_x.numpy(), want_x)


# ---------------------------------------------------- the restart table


def _window_rows(opt, oracle_rows, oracle, k):
    tbl = _np(opt._table)
    L, base = tbl.shape[0], opt._table_base
    while len(oracle_rows) < base + L:
        oracle_rows.append(oracle.next(k))
    for g in range(base, base + L):
        np.testing.assert_array_equal(tbl[g % L], oracle_rows[g])
    return tbl


def _same_tables(jopt, opt):
    np.testing.assert_array_equal(_np(opt._table), np.asarray(jopt._table))
    assert opt._table_base == jopt._table_base
    np.testing.assert_array_equal(_np(opt._stream[4]),
                                  np.asarray(jopt._stream[4]))


def _small_window(monkeypatch, table_max=8):
    _cadence(monkeypatch, 8, _TABLE_LEN_MIN=8, _TABLE_LEN_MAX=table_max,
             _MAX_RETRIES=4)


def test_adam_restart_table_never_wraps_as_jax(monkeypatch):
    """An 8-row window, a restart every segment, 40 segments: at every
    boundary both packages hold the same window, equal to the replayed
    Sobol rows base..base+L-1, and the same pointers."""
    k = 4
    _small_window(monkeypatch)
    jopt, opt = _pair(k=k, seg=8)
    x0 = jopt.init_points(k)
    opt.init_points(k)
    oracle = SobolStream(5)
    oracle.next(k)
    rows = []
    jx, tx = jnp.asarray(x0), torch.as_tensor(x0)
    for _ in range(40):
        jk, tk = _keys(jopt, opt, k)
        jopt._run_batch(jx, jk)
        opt._run_batch(tx, tk)
        _same_tables(jopt, opt)
        _window_rows(opt, rows, oracle, k)
    assert int(opt._stream[4].max()) >= 3 * 8 and opt._table_base > 0


def test_adam_refill_pointer_lift_cap_as_jax(monkeypatch):
    """A pointer spread past the 16-row cap: both packages lift the
    laggards to the same base instead of growing, and the live rows are
    the replayed Sobol rows."""
    k = 4
    _small_window(monkeypatch, table_max=16)
    jopt, opt = _pair(k=k, seg=8)
    x0 = jopt.init_points(k)
    opt.init_points(k)
    jk, tk = _keys(jopt, opt, k)
    jopt._run_batch(jnp.asarray(x0), jk)
    opt._run_batch(torch.as_tensor(x0), tk)
    skew = np.asarray([0, 1, 2, 100], np.int32)
    jopt._stream = jopt._stream[:4] + (jnp.asarray(skew),)
    opt._stream = opt._stream[:4] + (torch.as_tensor(skew),)
    jopt._maybe_refill_table(k, None)
    opt._maybe_refill_table(k)
    _same_tables(jopt, opt)
    base = opt._table_base
    assert _np(opt._table).shape[0] == 16 and base == 100 + 4 - 16
    ptr = _np(opt._stream[4])
    assert (ptr >= base).all() and ptr[3] == 100
    oracle = SobolStream(5)
    oracle.next(k)
    _window_rows(opt, [], oracle, k)


def test_adam_segment_uses_lifted_pointers_as_jax(monkeypatch):
    """A restart-due dispatch that lifts the pointers probes from the
    lifted ones in both packages."""
    k = 4
    _small_window(monkeypatch, table_max=16)
    jopt, opt = _pair(k=k, seg=8)
    x0 = jopt.init_points(k)
    opt.init_points(k)
    jx, tx = jnp.asarray(x0), torch.as_tensor(x0)
    jk, tk = _keys(jopt, opt, k)
    jopt._run_batch(jx, jk)
    opt._run_batch(tx, tk)
    skew = np.asarray([0, 1, 2, 100], np.int32)
    jopt._stream = jopt._stream[:4] + (jnp.asarray(skew),)
    opt._stream = opt._stream[:4] + (torch.as_tensor(skew),)
    jk, tk = _keys(jopt, opt, k)
    want = jopt._run_batch(jx, jk)
    got = opt._run_batch(tx, tk)
    _same_tables(jopt, opt)
    _close(got.x, want.x)
    base = opt._table_base
    ptr = _np(opt._stream[4])
    assert base > 0 and (ptr >= base).all()
    assert (ptr < base + 16 + 4).all()


def test_adam_sobol_contiguous_through_run_as_jax(monkeypatch):
    """``run()`` draws the start points once for persistent streams: after
    30 restart segments through the public loop the window is the plain
    continuation of the instance's Sobol stream in both packages, and the
    records agree."""
    k, seg, segments = 4, 8, 30
    _small_window(monkeypatch)
    jopt, opt = _pair(k=k, seg=seg, run_until_completion_its=segments * k *
                      seg)
    want, got = jopt.run(), opt.run()
    _same_tables(jopt, opt)
    oracle = SobolStream(5)
    oracle.next(k)
    _window_rows(opt, [], oracle, k)
    assert opt._table_base > 0 and int(opt._stream[4].max()) > 8
    assert abs(got - want) < 1e-10
    assert opt.record["func_calls"] == jopt.record["func_calls"]


# ---------------------------------------------------------------- run()


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy"])
def test_adam_run_records_match_jax(monkeypatch, regime):
    """run() in budget mode across a restart (cadence two segments):
    best_fid, func_calls, iterations, repeats, the controller, the top-c
    store (per-iteration candidates with the final points) and its
    checkpoints."""
    _cadence(monkeypatch, 2 * SEG)
    kw = dict(ham_noisy=True, noise=0.05) if regime == "ham_noisy" else {}
    jopt, opt = _pair(run_until_completion_its=5 * K * SEG, save_topc=24,
                      records_update_rate=2 * K * SEG, **kw)
    want, got = jopt.run(), opt.run()
    assert abs(got - want) < 1e-10
    for key in ("func_calls", "iterations", "repeats"):
        assert opt.record[key] == jopt.record[key], key
    assert opt.record["func_calls"] > 5 * K * SEG      # probes billed
    _close(opt.record["controller"], jopt.record["controller"])
    got_c = np.asarray(opt.record["controllers"])
    want_c = np.asarray(jopt.record["controllers"])
    assert got_c.shape == want_c.shape == (24, 5)
    _close(np.sort(got_c, axis=0), np.sort(want_c, axis=0))
    assert sorted(opt.records) == sorted(jopt.records)
    for fc in opt.records:
        _close(np.sort(opt.records[fc], axis=0),
               np.sort(jopt.records[fc], axis=0))


# -------------------------------------------------------------- float32


def _synthetic_objectives(monkeypatch, c):
    """Both packages' Adam on the gradient w - c (one exact subtraction,
    the same bits in both) and a constant ranking objective."""
    monkeypatch.setattr(jobj, "make_exact_gradient_batch", lambda spec: (
        lambda xs: (jnp.zeros(xs.shape[0], xs.dtype), xs - jnp.asarray(c))))
    monkeypatch.setattr(jobj, "make_infidelity_batch", lambda spec: (
        lambda xs, key: (jnp.zeros(xs.shape[0], xs.dtype),
                         jnp.ones(xs.shape[0], jnp.int32))))
    ct = torch.as_tensor(c)
    monkeypatch.setattr(objectives, "make_exact_gradient_batch", lambda spec: (
        lambda xs: (torch.zeros(xs.shape[0], dtype=xs.dtype), xs - ct)))
    monkeypatch.setattr(objectives, "make_infidelity_batch", lambda spec: (
        lambda xs, key: (torch.zeros(xs.shape[0], dtype=xs.dtype),
                         torch.ones(xs.shape[0], dtype=torch.int32))))


def _adam_model(w, m, v, c, steps, form, fused):
    """Adam in numpy float32: ``form`` "compiled" is the reference's
    compiled program (w - (m * c1) / (sqrt(v * c2) + eps) with the
    constants in float32), "division" the source's m / (1 - beta1) and
    v / (1 - beta2); ``fused`` rounds each moment update once, as XLA:CPU
    contracts it into a multiply-add (emulated in long double, whose 64-bit
    significand holds a float32 product exactly)."""
    f, ld = np.float32, np.longdouble
    c1 = f(0.03) * (f(1) / f(1 - 0.9))
    c2 = f(1) / f(1 - 0.999)
    for _ in range(steps):
        g = w - c
        if fused:
            m = (ld(f(0.9)) * ld(m) + ld(f(1 - 0.9) * g)).astype(f)
            v = (ld(f(0.999)) * ld(v) + ld(f(1 - 0.999) * g * g)).astype(f)
        else:
            m = f(0.9) * m + f(1 - 0.9) * g
            v = f(0.999) * v + f(1 - 0.999) * g * g
        if form == "compiled":
            w = w - m * c1 / (np.sqrt(v * c2) + f(1e-8))
        else:
            w = w - f(0.03) * (m / f(1 - 0.9)) / (
                np.sqrt(v / f(1 - 0.999)) + f(1e-8))
    return w, m, v


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) -
                      b.view(np.int32).astype(np.int64)).max())


def test_adam_step_f32_is_the_compiled_form(monkeypatch):
    """1000 float32 steps of both packages' Adam on the gradient w - c.
    The reference's compiled segment is, bit for bit, the product with the
    reciprocal of each constant divisor with eta folded in (and XLA:CPU's
    fused moment updates); the port is that form bit for bit with the
    moments rounded twice.  The source's division form parts from it by
    more than one ulp: one ulp a step does not stay one ulp.  (8 streams:
    torch's float32 sqrt on the CPU is not correctly rounded on tensors
    past 256 elements; on the card it is.)"""
    k, d, s = 8, 5, 1000
    rng = np.random.default_rng(0)
    c = rng.uniform(-5, 5, (k, d)).astype(np.float32)
    w0 = rng.uniform(-10, 10, (k, d)).astype(np.float32)
    m0, v0 = (rng.uniform(0, 1, (k, d)).astype(np.float32)
              for _ in range(2))
    _synthetic_objectives(monkeypatch, c)
    monkeypatch.setattr(jbase, "_PROGRAM_CACHE", OrderedDict())
    jopt, opt = _pair(k=k, seg=s, dtype=F32)
    plain = jopt._build_segments(k)[0]
    out = plain(jnp.asarray(w0), jnp.asarray(m0), jnp.asarray(v0),
                jnp.zeros(k, jnp.int32), jnp.zeros(k, jnp.int32),
                jax.random.split(jax.random.key(0), k),
                jnp.zeros((8, k, d), jnp.float32), jopt._noise_operand())
    ref = [np.asarray(x) for x in out[:3]]
    assert ref[0].dtype == np.float32
    compiled_fused = _adam_model(w0, m0, v0, c, s, "compiled", True)
    for a, b in zip(ref, compiled_fused):
        np.testing.assert_array_equal(a, b)

    got = opt._segment(*(torch.as_tensor(x) for x in (w0, m0, v0)),
                       torch.zeros(k, dtype=torch.int32), prng.key(0),
                       False)
    compiled = _adam_model(w0, m0, v0, c, s, "compiled", False)
    for a, b in zip(got[:3], compiled):
        np.testing.assert_array_equal(a.numpy(), b)
    division = _adam_model(w0, m0, v0, c, s, "division", False)
    assert _ulps(division[0], compiled[0]) > 1
    assert _ulps(division[2], compiled[2]) > 1
    # the constants: eta / (1 - beta1) and 1 / (1 - beta2) in float32
    c1, c2 = tadam._consts(0.03, torch.float32)
    assert np.float32(c1) == np.float32(0.03) * np.float32(10.0)
    assert np.float32(c2) == np.float32(1) / np.float32(0.001)


def test_adam_restart_candidates_f32_are_the_references_arithmetic():
    """N=7, 64 streams, float32: the table is the Sobol draws after the 64
    start draws rounded to float32 when made (the reference's jnp.asarray
    without x64), and a candidate is lower + (upper - lower) * u in
    float32, bit for bit.  (The first 2^24 draws of an unscrambled Sobol
    sequence are dyadic with at most 24 bits, so here the rounding at
    creation is exact and a float64 candidate rounded once is the same
    number; the test holds the form, which stays right past them.)"""
    k, n = 64, 7
    opt = Adam(n, 0, n - 1, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=10**6,
               landscape_exploration=True, restart_batch=k, segment_its=1,
               **F32)
    x0 = opt.init_points(k)
    opt._run_batch(torch.as_tensor(x0, dtype=torch.float32),
                   prng.split(prng.key(0), k))
    oracle = SobolStream(n + 1)
    oracle.next(k)
    rows = opt._table.shape[0]
    u = oracle.next(rows * k).reshape(rows, k, n + 1)
    assert opt._table.dtype == torch.float32
    np.testing.assert_array_equal(opt._table.numpy(), u.astype(np.float32))

    ptr = torch.as_tensor(np.arange(k) * 3 % rows, dtype=torch.int32)
    big = torch.full((k, n + 1), 10.0)      # every first probe passes
    w, ptr_after, tries = opt._retry_restart(
        torch.zeros(k, n + 1), ptr, lambda xs: (None, big))
    assert bool((tries == 1).all()) and bool((ptr_after == ptr + 1).all())
    lo = np.asarray([b[0] for b in opt.val_bounds], np.float32)
    hi = np.asarray([b[1] for b in opt.val_bounds], np.float32)
    uu = u.astype(np.float32)[ptr.numpy(), np.arange(k)]
    want = lo + (hi - lo) * uu
    assert want.dtype == np.float32
    np.testing.assert_array_equal(w.numpy().view(np.int32),
                                  want.view(np.int32))


def test_adam_start_moments_are_jax_uniforms_in_both_regimes():
    """m0 and v0 are ``jax.random.uniform`` in jax's default float:
    float64 under x64 (the CPU tests), float32 without (the card).  The
    port draws them in the run's dtype, which is that float in both
    regimes."""
    for dtype, jdt in ((F64, jnp.float64), (F32, jnp.float32)):
        jopt, opt = _pair(k=4, seg=8, dtype=dtype)
        x0 = jopt.init_points(4)
        seen = []
        segment = opt._segment
        opt._segment = lambda w, m, v, *a: seen.append((m, v)) or segment(
            w, m, v, *a)
        opt._run_batch(torch.as_tensor(x0, dtype=dtype["dtype"]),
                       prng.split(prng.key(0), 4))
        for got in seen[0]:
            want = jax.random.uniform(jopt.next_key(), (4, 5), jdt)
            assert got.dtype == dtype["dtype"]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ registry and refusals


def test_registry_keys_are_the_references():
    assert sorted(MODEL_REGISTRY) == sorted(JREGISTRY)
    assert MODEL_REGISTRY["adam"] is Adam and MODEL_REGISTRY["snob"] is SNOB
    for name, cls in MODEL_REGISTRY.items():
        assert cls.name == JREGISTRY[name].name


def test_adam_refusals():
    kw = dict(testing=True, fid_threshold=0.0, run_until_told_to_stop=True,
              run_until_completion_its=1000, landscape_exploration=True,
              save_topc=8, **F64)
    with pytest.raises(ValueError, match="restart cadence"):
        Adam(4, 0, 2, segment_its=999, **kw)
    Adam(4, 0, 2, segment_its=500, **kw)
    with pytest.raises(Exception, match="isn't available"):
        Adam(4, 0, 2, testing=True, **F64)
    with pytest.raises(Exception, match="isn't available"):
        Adam(4, 0, 2, **dict(kw, landscape_exploration=False))
    # mesh was refused until it was ported: a noiseless segment sharded
    # over two CPU entries advances each stream as the unsharded one does
    kw.update(restart_batch=4, segment_its=10, seed=2)
    sharded = Adam(4, 0, 2, mesh=Mesh(["cpu"] * 2), **kw)
    plain = Adam(4, 0, 2, **kw)
    x0 = torch.as_tensor(plain.init_points(4))
    sharded.init_points(4)
    keys = prng.split(prng.key(0), 4)
    got, want = sharded._run_batch(x0, keys), plain._run_batch(x0, keys)
    for name in ("x", "fid", "true_fid", "nfev", "cand_fid", "cand_x"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("cls", [Adam, SNOB])
def test_no_cpu_fallback(cls):
    """``device=None`` means the card: without CUDA it raises."""
    kw = dict(testing=True, run_until_told_to_stop=True,
              landscape_exploration=True)
    if torch.cuda.is_available():
        assert cls(4, 0, 2, **kw).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        cls(4, 0, 2, **kw)
