"""The port's MCDataSim (code_robchar_tpu_torch/mc/datasim.py) against the
JAX package's, at float64 on the CPU, and the engine's two routes.

The store: an N=4 chain (0 -> 2), 8 controllers a set from numpy seed 0,
with one set short at 5 controllers and one empty; 3 noise levels,
bootreps 16, seed 0.  Bars: fidelity tensors and metric dicts within
1e-10 (the parity bar) on both routes; caches written by one package are
loaded by the other with its sweep made to raise; the ranking, pooling,
bootstrap and merge helpers give equal results on the two packages'
outputs."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from code_robchar_tpu.mc import datasim as jdatasim
from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu_torch.mc import datasim, engine
from code_robchar_tpu_torch.ops import chain, prng
from code_robchar_tpu_torch.utils import build

N, IN, OUT, C, B = 4, 0, 2, 8, 16
NOISES = np.linspace(0, 0.1, 3)
EXP = "pipeline_unit"
STORE = f"ppo_spin_{N}_{IN}-{OUT}_c_{C}.le"
#: (algo, training noise) of every set in the store; lbfgs is keyed by
#: str(N) and characterised with training noise None
SETS = [("lbfgs", None), ("nmplus", "0.0"), ("nmplus", "0.05"),
        ("snob", "0.0"), ("snob", "0.05")]


def _controllers(rng, k):
    return np.column_stack([rng.uniform(-2, 2, (k, N)),
                            rng.uniform(1, 5, k)]).tolist()


def _store(short=5, empty=True):
    rng = np.random.default_rng(0)
    return {"lbfgs": {str(N): {"controller": _controllers(rng, C)}},
            "nmplus": {"0.0": {"controller": _controllers(rng, C)},
                       "0.05": {"controller": _controllers(rng, short)}},
            "snob": {"0.0": {"controller": _controllers(rng, C)},
                     "0.05": {"controller":
                              [] if empty else _controllers(rng, C)}}}


def _write_store(root, store, exp=EXP):
    d = root / exp
    d.mkdir(parents=True, exist_ok=True)
    (d / STORE).write_text(json.dumps(store))
    return str(root)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sims(root, port_jacobi=True, jax_jacobi=True):
    """The two packages' MCDataSim on ``root/port`` and ``root/jax``;
    ``None`` leaves ``use_jacobi`` at the package's default."""
    common = dict(Nspin=N, inspin=IN, outspin=OUT, noises=NOISES,
                  bootreps=B, numcontrollers=C, filemarker=".le", seed=0)
    pkw = {} if port_jacobi is None else dict(use_jacobi=port_jacobi)
    jkw = {} if jax_jacobi is None else dict(use_jacobi=jax_jacobi)
    port = datasim.MCDataSim(EXP, global_experiments_directory=str(
        root / "port"), device="cpu", dtype=torch.float64, **common, **pkw)
    jax = jdatasim.MCDataSim(EXP, global_experiments_directory=str(
        root / "jax"), **common, **jkw)
    return port, jax


def _trees(tmp_path, store=None):
    store = _store() if store is None else store
    for pkg in ("port", "jax"):
        _write_store(tmp_path / pkg, store)
    return tmp_path


def _close_dicts(a, b, tol):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k], dtype=float), np.asarray(b[k], dtype=float)
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=k)
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("port_jacobi,jax_jacobi", [
    (True, True), (False, False), (None, None)],
    ids=["jacobi", "lapack", "defaults"])
def test_fid_dists_and_metrics_match_jax(tmp_path, port_jacobi, jax_jacobi):
    """Both routes, and the port's default (Jacobi) against the JAX
    package's (its LAPACK path): every set, NaN where a set is short."""
    port, jax = _sims(_trees(tmp_path), port_jacobi, jax_jacobi)
    if port_jacobi is None:
        assert port.use_jacobi and not jax.use_jacobi
    for algo, tn in SETS:
        got = port.get_fid_dists(tn, algoname=algo)
        want = jax.get_fid_dists(tn, algoname=algo)
        assert got[algo].shape == (3, C, B)
        _close_dicts({algo: got[algo]}, {algo: want[algo]}, 1e-10)
        md, jmd = (s.get_metrics_dict(tn, algoname=algo)[algo]
                   for s in (port, jax))
        assert len(md) == 15
        _close_dicts(md, jmd, 1e-10)
    short = port.get_fid_dists("0.05", algoname="nmplus")["nmplus"]
    assert np.isnan(short[:, 5:]).all() and np.isfinite(short[:, :5]).all()
    empty = port.get_fid_dists("0.05", algoname="snob")["snob"]
    assert np.isnan(empty).all()
    # the cache files carry the JAX package's names
    names = sorted(os.listdir(tmp_path / "port" / EXP))
    assert names == sorted(os.listdir(tmp_path / "jax" / EXP))
    assert f"{STORE}_tn0.05_br_{B}_nlvl[0.   0.05 0.1 ].mc" in names


def _forbid_sweep(monkeypatch, module):
    def boom(*a, **k):
        raise AssertionError("the cached set was swept again")
    monkeypatch.setattr(module, "mc_fidelity_sweep", boom)


def _characterise_all(sim):
    return {(a, tn): (sim.get_fid_dists(tn, algoname=a)[a],
                      sim.get_metrics_dict(tn, algoname=a)[a])
            for a, tn in SETS}


@pytest.mark.parametrize("sidecar", [True, False], ids=["mcb", "json"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_load_across_packages(tmp_path, monkeypatch, sidecar,
                                     writer):
    """Caches written by one package are read by the other with no sweep
    (its mc_fidelity_sweep raises), with and without the .mcb sidecar."""
    root = _trees(tmp_path)
    port, jax = _sims(root)
    src, dst = (port, jax) if writer == "port" else (jax, port)
    wrote = _characterise_all(src)
    # the other package reads the writer's directory
    shutil.rmtree(root / (writer == "port" and "jax" or "port"))
    shutil.copytree(root / writer, root / (writer == "port" and "jax"
                                            or "port"))
    if not sidecar:
        for d in (root / "port" / EXP, root / "jax" / EXP):
            for f in os.listdir(d):
                if f.endswith(".mcb"):
                    os.remove(d / f)
    _forbid_sweep(monkeypatch, jengine if writer == "port" else engine)
    port, jax = _sims(root)
    dst = jax if writer == "port" else port
    read = _characterise_all(dst)
    for k in wrote:
        np.testing.assert_array_equal(read[k][0], wrote[k][0])
        _close_dicts(read[k][1], wrote[k][1], 0.0)


def test_engine_routes_agree():
    """use_jacobi=False (complex eigh, ops/propagate.py) against True (the
    Jacobi plain version) on the same keys: within 1e-10."""
    rng = np.random.default_rng(3)
    h0 = chain.xx_hamiltonian_real(N, dtype=torch.float64)
    xs = np.asarray(_controllers(rng, 6))
    kw = dict(device="cpu")
    a = engine.mc_fidelity_sweep(h0, xs, NOISES, prng.key(4), B, IN, OUT,
                                 use_jacobi=True, **kw)
    b = engine.mc_fidelity_sweep(h0, xs, NOISES, prng.key(4), B, IN, OUT,
                                 use_jacobi=False, **kw)
    assert float(a.std()) > 0.05
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-10)
    for fused in (True, False):
        ma = engine.characterise(h0, xs, NOISES, prng.key(4), B, IN, OUT,
                                 return_fids=not fused, use_jacobi=True,
                                 **kw)
        mb = engine.characterise(h0, xs, NOISES, prng.key(4), B, IN, OUT,
                                 return_fids=not fused, use_jacobi=False,
                                 **kw)
        _close_dicts({k: v.numpy() for k, v in ma.items()},
                     {k: v.numpy() for k, v in mb.items()}, 1e-10)
    # the complex route takes no Jacobi kernel on any device
    before = build.LAUNCHES.copy()
    engine.mc_metric_sweep(h0, xs, NOISES, prng.key(4), B, IN, OUT,
                           use_jacobi=False, **kw)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("fn", ["propagator", "transfer_fidelity",
                                "fidelity_from_controller",
                                "fidelity_batch"])
def test_propagate_matches_jax(fn):
    """ops/propagate.py's four functions against the JAX package's on
    seeded complex drifts (N=4, 0 -> 2): within 1e-10."""
    from code_robchar_tpu.ops import propagate as jprop
    from code_robchar_tpu_torch.ops import propagate

    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, N, N)) + 1j * rng.normal(size=(6, N, N))
    h = (a + np.conj(np.swapaxes(a, -1, -2))) / 2
    xs = np.asarray(_controllers(rng, 6))
    t = xs[:, N]
    args = {"propagator": lambda: (h, t),
            "transfer_fidelity": lambda: (h, t, IN, OUT),
            "fidelity_from_controller": lambda: (h, xs, IN, OUT),
            "fidelity_batch": lambda: (h[0], xs, IN, OUT)}[fn]()
    want = np.asarray(getattr(jprop, fn)(*args))
    got = getattr(propagate, fn)(*(torch.as_tensor(v) if isinstance(
        v, np.ndarray) else v for v in args)).numpy()
    assert want.shape == got.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_ranking_and_pooling_helpers_equal(tmp_path):
    store = _store(short=C, empty=False)
    store["lbfgs"][str(N)]["controller"] = \
        store["lbfgs"][str(N)]["controller"][:5]       # zero-padded pool
    port, jax = _sims(_trees(tmp_path, store))
    rim = r"$W(.,\delta(x-1))$"
    md = port.get_metrics_dict("0.0", algoname="nmplus")["nmplus"]
    jmd = jax.get_metrics_dict("0.0", algoname="nmplus")["nmplus"]
    c, u, lo = (np.asarray(md[rim + s]) for s in ("", " upper", " lower"))
    jc, ju, jl = (np.asarray(jmd[rim + s]) for s in ("", " upper",
                                                     " lower"))
    _close_dicts({"c": c, "u": u, "l": lo}, {"c": jc, "u": ju, "l": jl},
                 1e-10)
    # equal inputs to both helpers, so equal outputs
    for a, b in zip(port.get_best_controller_perf(jc),
                    jax.get_best_controller_perf(jc)):
        np.testing.assert_array_equal(a, b)
    for topk, thres in ((4, 0.8), (3, 0.0), (8, None)):
        for a, b in zip(port.get_top_k_by_fid(jc, ju, jl, topk, thres),
                        jax.get_top_k_by_fid(jc, ju, jl, topk, thres)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port.get_top_k_by_fid_idx(jc, 3),
                    jax.get_top_k_by_fid_idx(jc, 3)):
        np.testing.assert_array_equal(a, b)
    fids = port.get_fid_dists("0.0", algoname="nmplus")["nmplus"][0]
    np.testing.assert_array_equal(port.sort_fids_by(fids, jc[0], 5),
                                  jax.sort_fids_by(fids, jc[0], 5))
    np.testing.assert_array_equal(port.get_all_algo_controllers(),
                                  jax.get_all_algo_controllers())
    for (n_a, a), (n_b, b) in zip(port._controller_slots(),
                                  jax._controller_slots()):
        assert n_a == n_b
        np.testing.assert_array_equal(a, b)
    assert len(port._controller_slots()) == 5
    np.testing.assert_array_equal(port.get_ranks(jc[0]),
                                  jax.get_ranks(jc[0]))
    wd = port.get_wd_data_c("nmplus")
    jwd = jax.get_wd_data_c("nmplus")
    for a, b in zip(wd, jwd):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_bootstrap_resampling_std_matches_jax(tmp_path):
    import jax.numpy as jnp

    port, jax = _sims(_trees(tmp_path))
    sample = np.random.default_rng(9).uniform(size=40)
    for stat, jstat in ((lambda x: x.mean(-1), jnp.mean),
                        (lambda x: x.amin(-1), jnp.min)):
        got = port.bootstrap_resampling_std(stat, sample, 50)
        want = jax.bootstrap_resampling_std(jstat, sample, 50)
        assert got > 0
        assert abs(got - want) <= 1e-12


def test_merge_controller_files_and_mcdata_equal(tmp_path):
    """Both packages merge the same inputs into equal files."""
    a_store, b_store = _store(), _store(short=C, empty=False)
    del a_store["snob"]
    b_store["ppo"] = {"0.0": {"controller": b_store["nmplus"]["0.0"][
        "controller"]}}
    for pkg in ("port", "jax"):
        _write_store(tmp_path / pkg, a_store)
        _write_store(tmp_path / pkg, b_store, exp="pipeline_other")
    port, jax = _sims(tmp_path)
    # characterise one set in each directory with the port, then give
    # both trees the same caches
    port.get_metrics_dict("0.0", algoname="nmplus")
    other = datasim.MCDataSim(
        "pipeline_other", Nspin=N, inspin=IN, outspin=OUT, noises=NOISES,
        bootreps=B, numcontrollers=C, filemarker=".le",
        global_experiments_directory=str(tmp_path / "port"), device="cpu",
        dtype=torch.float64)
    other.get_metrics_dict("0.0", algoname="snob")
    shutil.rmtree(tmp_path / "jax")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    port, jax = _sims(tmp_path)
    for sim in (port, jax):
        sim.merge_controller_files("pipeline_other")
        sim.merge_mcdata("pipeline_other")
    assert port.controllers == jax.controllers
    assert set(port.controllers) == {"lbfgs", "nmplus", "snob", "ppo"}
    for f in sorted(os.listdir(tmp_path / "port" / EXP)):
        if f.endswith(".mcb"):
            continue
        a = json.loads((tmp_path / "port" / EXP / f).read_text())
        b = json.loads((tmp_path / "jax" / EXP / f).read_text())
        assert set(a) == set(b), f
        for k in a:
            if f.endswith(".mcm"):
                _close_dicts(a[k], b[k], 0.0)
            elif not f.endswith(".le"):
                np.testing.assert_array_equal(np.asarray(a[k], dtype=float),
                                              np.asarray(b[k], dtype=float))
    merged = json.loads(
        (tmp_path / "port" / EXP / (STORE + f"_tn0.0_br_{B}_nlvl"
                                    "[0.   0.05 0.1 ].mc")).read_text())
    assert set(merged) == {"nmplus", "snob"}


def test_missing_store_and_errors(tmp_path):
    port = datasim.MCDataSim(EXP, Nspin=N, numcontrollers=C,
                             global_experiments_directory=str(tmp_path),
                             device="cpu")
    assert port.controllers is None and port.algos is None
    with pytest.raises(datasim.DirectoryDoesNotExistError):
        port.get_path("nowhere")
    _write_store(tmp_path, _store())
    with pytest.raises(ValueError):
        port.get_path(EXP, of="x")
    with pytest.raises(TypeError):
        datasim.MCDataSim.ctrlnames(3)
    assert datasim.MCDataSim.ctrlnames([[0.0] * 5]) == ["unnamed"]
