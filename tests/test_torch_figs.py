"""The port's figure classes (code_robchar_tpu_torch/figs) against the JAX
package's, at float64 on the CPU: the data methods of every figure.

The store: an N=4 chain (0 -> 2), 6 controllers a set from numpy seed 3
(lbfgs under "4", ppo under "0.0" and "0.05", snob under "0.05"), 3 noise
levels, bootreps 8, seed 0, top-k 4: the size of tests/test_figs.py.
Bars: every value within 1e-10 (the parity bar), the Kendall taus equal.

The JAX side stays cheap.  The MCDataSim figures (figs 3, 4, 5, rimk) read
the ``.mc`` / ``.mcm`` caches that the port wrote, with the JAX sweep made
to raise.  Figs 8 and 1 call the sweep themselves: there the JAX module's
``engine.mc_fidelity_sweep`` is replaced by a stub that returns the port's
float64 sweep for the key the JAX class passed (the sweep itself is held
in tests/test_torch_engine.py), and one tiny fig 8 case runs the real JAX
sweep, so that the key of every checkpoint is held end to end."""

import json
import shutil

import numpy as np
import pytest
import torch

import code_robchar_tpu.figs as jfigs
from code_robchar_tpu.figs import rimk as jrimk
from code_robchar_tpu.mc import engine as jengine
import code_robchar_tpu_torch.figs as pfigs
from code_robchar_tpu_torch.figs import rimk as primk
from code_robchar_tpu_torch.mc import engine as pengine
from code_robchar_tpu_torch.ops import prng

N, C, B = 4, 6, 8
NOISES = np.linspace(0, 0.1, 3)
EXP = "pipeline_figs"
STORE = f"ppo_spin_{N}_0-2_c_{C}.le"
TOPK = 4
TOL = 1e-10
#: (algo, training-noise key) of every set; lbfgs is keyed by str(N) and
#: characterised with the key None
SETS = [("lbfgs", None), ("ppo", "0.0"), ("ppo", "0.05"), ("snob", "0.05")]
SET_IDS = [f"{a}-{k}" for a, k in SETS]
FIG_CLASSES = ("IndividualContComparisons", "KTRConsistency",
               "ARIMGenerator", "ExploringRIMK")


def _controllers(rng, k=C, n=N):
    return np.column_stack([rng.uniform(-2, 2, (k, n)),
                            rng.uniform(1, 5, k)]).tolist()


def _store():
    rng = np.random.default_rng(3)
    return {"lbfgs": {str(N): {"controller": _controllers(rng)}},
            "ppo": {"0.0": {"controller": _controllers(rng)},
                    "0.05": {"controller": _controllers(rng)}},
            "snob": {"0.05": {"controller": _controllers(rng)}}}


def _kwargs(root, port):
    kw = dict(Nspin=N, inspin=0, outspin=2, noises=NOISES, bootreps=B,
              numcontrollers=C, filemarker=".le", topk=TOPK, seed=0,
              global_experiments_directory=str(root / "experiments"))
    if port:
        kw.update(device="cpu", dtype=torch.float64)
    return kw


def _figure(pkg, name, root, port):
    kw = _kwargs(root, port)
    if name != "ExploringRIMK":
        kw["fig_dir"] = str(root / "figs")
    return getattr(pkg, name)(EXP, **kw)


def _results(sims):
    """Every data method of the four MCDataSim figures on every set."""
    fig3, fig4, fig5, rimk = (sims[n] for n in FIG_CLASSES)
    out = {}
    for algo, key in SETS:
        out["bands", algo, key] = fig3._rim_bands(algo, key, NOISES, None)
        out["bands_topk", algo, key] = fig3._rim_bands(algo, key, NOISES,
                                                       TOPK, 0.2)
        rim = fig4._rim(algo, key, fig4.topk)
        out["rim", algo, key] = rim
        before = fig4.vn_failures
        out["taus", algo, key] = (fig4.pairwise_taus(rim, 0.05),
                                  fig4.vn_failures - before)
        out["arim", algo, key] = fig5.arim_curve(algo, key, bootsamples=20)
    for algo in ("lbfgs", "ppo", "snob"):
        out["rimk", algo] = rimk.rim_k_tensor(algo, noise_index=1, topk=3)
    out["q_vs_rim"] = rimk.q_vs_rim_rank_agreement("ppo", noise_index=1)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's results (it sweeps and writes the caches), then the JAX
    package's on a copy of those caches with its sweep made to raise."""
    root = tmp_path_factory.mktemp("figs")
    home = root / "port" / "experiments" / EXP
    home.mkdir(parents=True)
    (home / STORE).write_text(json.dumps(_store()))
    port = _results({c: _figure(pfigs, c, root / "port", True)
                     for c in FIG_CLASSES})
    shutil.copytree(root / "port" / "experiments",
                    root / "jax" / "experiments")

    def boom(*a, **k):
        raise AssertionError("the JAX figure swept a cached set again")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "mc_fidelity_sweep", boom)
        jax = _results({c: _figure(jfigs if c != "ExploringRIMK" else jrimk,
                                   c, root / "jax", False)
                        for c in FIG_CLASSES})
    return port, jax


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("algo,key", SETS, ids=SET_IDS)
def test_fig3_rim_bands_match_jax(both, algo, key):
    port, jax = both
    for name in ("bands", "bands_topk"):
        for got, want in zip(port[name, algo, key], jax[name, algo, key]):
            _close(got, want)
    c = port["bands", algo, key][0]
    assert c.shape == (len(NOISES), C) and np.isfinite(c).all()
    assert port["bands_topk", algo, key][0].shape[1] <= TOPK


@pytest.mark.parametrize("algo,key", SETS, ids=SET_IDS)
def test_fig4_pairwise_taus_equal_jax(both, algo, key):
    port, jax = both
    _close(port["rim", algo, key], jax["rim", algo, key])
    (taus, fails), (jtaus, jfails) = (port["taus", algo, key],
                                      jax["taus", algo, key])
    assert taus.shape == (len(NOISES), len(NOISES))
    np.testing.assert_array_equal(taus, jtaus)
    assert fails == jfails


@pytest.mark.parametrize("algo,key", SETS, ids=SET_IDS)
def test_fig5_arim_curve_matches_jax(both, algo, key):
    port, jax = both
    (arim, err), (jarim, jerr) = port["arim", algo, key], \
        jax["arim", algo, key]
    _close(arim, jarim)
    _close(err, jerr)
    assert arim.shape == (len(NOISES),) and (err > 0).any()


def test_fig5_bootstrap_takes_the_figure_dtype(tmp_path):
    """arim_curve's bootstrap resamples the sample in the figure's dtype,
    as the JAX package does in its precision (at float32 the int32
    indices of ``prng.key(seed + 1)``, at float64 the int64 ones)."""
    home = tmp_path / "experiments" / EXP
    home.mkdir(parents=True)
    (home / STORE).write_text(json.dumps(_store()))
    sample = np.random.default_rng(4).uniform(size=40)
    stat = pfigs.fig5.wd_from_ideal_zero
    for dtype in (torch.float32, torch.float64):
        sim = pfigs.ARIMGenerator(EXP, **dict(
            _kwargs(tmp_path, True), dtype=dtype,
            fig_dir=str(tmp_path / "figs")))
        want = pengine.bootstrap_statistic_std(
            prng.key(1), torch.as_tensor(sample, dtype=dtype), stat, 30)
        assert want.dtype == dtype
        assert sim.bootstrap_resampling_std(stat, sample, 30) == float(want)


@pytest.mark.parametrize("algo", ["lbfgs", "ppo", "snob"])
def test_rimk_tensor_matches_jax(both, algo):
    port, jax = both
    got, want = port["rimk", algo], jax["rimk", algo]
    assert list(got) == list(want) == ["RIM_1", "RIM_2", "RIM_3", "var",
                                       "mean"]
    for k in got:
        _close(got[k], want[k])
    # ranks 0..topk are kept: topk + 1 controllers (the reference's <=)
    assert got["RIM_1"].shape == (len(NOISES), 4)


def test_rimk_q_vs_rim_matches_jax(both):
    port, jax = both
    assert abs(port["q_vs_rim"] - jax["q_vs_rim"]) <= TOL or \
        (np.isnan(port["q_vs_rim"]) and np.isnan(jax["q_vs_rim"]))


def test_noise_keys_stay_float64_strings_at_float32(tmp_path):
    """At float32 the training-noise key is still str() of the float64
    grid: rim_k_tensor's set and its cache name are the float64 run's."""
    home = tmp_path / "experiments" / EXP
    home.mkdir(parents=True)
    (home / STORE).write_text(json.dumps(_store()))
    kw = dict(_kwargs(tmp_path, True), dtype=torch.float32)
    sim = primk.ExploringRIMK(EXP, **kw)
    assert sim.noises.dtype == np.float64
    out = sim.rim_k_tensor("snob", noise_index=1, topk=3)
    assert out["RIM_1"].dtype == np.float32
    names = sorted(p.name for p in home.iterdir())
    assert f"{STORE}_tn0.05_br_{B}_nlvl[0.   0.05 0.1 ].mc" in names


def test_rimk_synthetic_studies_match_jax():
    """The numpy tail studies are copies: equal values."""
    for a in (0.001, 0.3):
        got, want = primk.moments_vs_tails(a), jrimk.moments_vs_tails(a)
        assert list(got) == list(want)
        for name in got:
            for k in got[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])
    assert primk.p_rim_growth_curves() == jrimk.p_rim_growth_curves()
    x = primk.dom(0.2, 1, 50)
    for tail in ("right_tail", "left_tail", "gaussian", "uniform"):
        np.testing.assert_array_equal(getattr(primk, tail)(x),
                                      getattr(jrimk, tail)(x))


# ------------------------------------------------------------- fig 8 and 1

SCALE_EXP = "pipeline_scaling"
FCALLS = ("1000", "2000", "3000")


def _scaling_store(rng, n_ctrl=C):
    return {algo: {nl: {f: _controllers(rng, n_ctrl) for f in FCALLS}
                   for nl in ("0.0", "0.05")}
            for algo in ("lbfgs", "ppo", "snob", "nmplus")}


def _write_scaling(root, n_ctrl=C):
    rng = np.random.default_rng(5)
    home = root / "experiments" / SCALE_EXP
    home.mkdir(parents=True)
    for marker in ("sh", "nsh"):
        (home / f"ppo_spin_{N}_0-2_c_{n_ctrl}.le_{marker}").write_text(
            json.dumps(_scaling_store(rng, n_ctrl)))


def _nstoch(pkg, root, port, bootreps=B, n_ctrl=C):
    kw = dict(_kwargs(root, port), bootreps=bootreps, numcontrollers=n_ctrl,
              fig_dir=str(root / "figs"))
    return pkg.NStochOpt(SCALE_EXP, **kw)


def port_sweep_stub(keys):
    """A stand-in for the JAX engine's mc_fidelity_sweep: the port's float64
    sweep on the CPU for the key the JAX caller passed (recorded)."""
    import jax
    import jax.numpy as jnp

    sweep = pengine.mc_fidelity_sweep

    def stub(h0, controllers, noises, key, bootreps, in_spin, out_spin,
             complex_offdiag=True, **_):
        data = np.asarray(jax.random.key_data(key))
        keys.append(data)
        fids = sweep(
            np.array(h0), np.asarray(controllers, dtype=np.float64),
            np.asarray(noises, dtype=np.float64), prng.key_from_data(data),
            bootreps, in_spin, out_spin, complex_offdiag=complex_offdiag,
            device="cpu")
        return jnp.asarray(fids.numpy())

    return stub


@pytest.fixture
def scaling(tmp_path, monkeypatch):
    """fig 8 on both packages, each in its own directory; the JAX sweep is
    the port's (stubbed)."""
    for pkg in ("port", "jax"):
        _write_scaling(tmp_path / pkg)
    keys = []
    monkeypatch.setattr(jfigs.fig8.engine, "mc_fidelity_sweep",
                        port_sweep_stub(keys))
    return (_nstoch(pfigs, tmp_path / "port", True),
            _nstoch(jfigs, tmp_path / "jax", False), keys)


@pytest.mark.parametrize("marker", ["", "nonstoch"])
@pytest.mark.parametrize("algo", ["lbfgs", "ppo", "snob", "nmplus"])
def test_fig8_get_arims_matches_jax(scaling, algo, marker):
    port, jax, keys = scaling
    cdict = "c_dict_sh" if marker == "" else "c_dict_nsh"
    got, gkeys = port.get_arims(algo, "0.05", marker, getattr(port, cdict))
    want, wkeys = jax.get_arims(algo, "0.05", marker, getattr(jax, cdict))
    assert gkeys == wkeys == list(FCALLS)
    assert got.dtype == np.float64 and got.shape == (3, len(NOISES))
    _close(got, want)
    # the same key, key(seed), for every checkpoint
    assert len(keys) == len(FCALLS)
    for k in keys:
        np.testing.assert_array_equal(k, prng.key(0).numpy())
    # get_rims: one controller's mean infidelity per noise level
    cont = port.c_dict_sh[algo]["0.05"][FCALLS[0]][0]
    _close(port.get_rims(cont), jax.get_rims(cont))


def test_fig8_real_jax_sweep_per_checkpoint(tmp_path):
    """The real JAX sweep (C=2, two checkpoints, bootreps 4): the port's
    tensor equals it within the bar, so each checkpoint's key is held end
    to end."""
    rng = np.random.default_rng(8)
    store = {"ppo": {"0.05": {f: _controllers(rng, 2)
                              for f in FCALLS[:2]}}}
    for pkg in ("port", "jax"):
        home = tmp_path / pkg / "experiments" / SCALE_EXP
        home.mkdir(parents=True)
        for marker in ("sh", "nsh"):
            (home / f"ppo_spin_{N}_0-2_c_2.le_{marker}").write_text(
                json.dumps(store))
    port = _nstoch(pfigs, tmp_path / "port", True, bootreps=4, n_ctrl=2)
    jax = _nstoch(jfigs, tmp_path / "jax", False, bootreps=4, n_ctrl=2)
    got, gk = port.get_arims("ppo", "0.05", "", port.c_dict_sh)
    want, wk = jax.get_arims("ppo", "0.05", "", jax.c_dict_sh)
    assert gk == wk == list(FCALLS[:2])
    assert got.shape == (2, len(NOISES)) and (got[:, 1:] > 0).all()
    _close(got, want)


def _legacy(root):
    rng = np.random.default_rng(1)
    d = root / "noisy_analysis"
    d.mkdir(parents=True)
    (d / f"lbfgs_spin_{N}_0-2_in").write_text(json.dumps(
        {"lbfgs": {str(N): {"controller": _controllers(rng)}}}))
    (d / f"ppo_spin_{N}_0-2_in").write_text(json.dumps(
        {"ppo": {"0.0": {"controller": _controllers(rng)},
                 "0.01": {"controller": _controllers(rng)}}}))
    return str(d)


def test_fig1_sd_results_and_ecdfs_match_jax(tmp_path, monkeypatch):
    keys = []
    monkeypatch.setattr(jfigs.fig1.engine, "mc_fidelity_sweep",
                        port_sweep_stub(keys))
    legacy = _legacy(tmp_path)
    kw = dict(spin=N, inspin=0, outspin=2, bootreps=16, controllers=4)
    port = pfigs.CDFAreaExample(legacy, device="cpu", dtype=torch.float64,
                                **kw)
    jax = jfigs.CDFAreaExample(legacy, **kw)
    assert port.rlc_index == jax.rlc_index == "0.01"
    grid = np.linspace(0, 0.2, 3)
    (noises, fl, fp), (jn, jfl, jfp) = (port.get_sd_results(grid),
                                        jax.get_sd_results(grid))
    np.testing.assert_array_equal(noises, jn)
    assert fl.shape == fp.shape == (2, 4, 16) and fl.dtype == np.float64
    _close(fl, jfl)
    _close(fp, jfp)
    assert len(keys) == 2
    for k in keys:
        np.testing.assert_array_equal(k, prng.key(0).numpy())
    for j in range(2):
        got = port.joint_ecdfs(fl[j, 0], fp[j, 0])
        want = jax.joint_ecdfs(jfl[j, 0], jfp[j, 0])
        for a, b in zip(got, want):
            _close(a, b)
    # complex_offdiag=False: the draws differ from the True sweep's
    other = pengine.mc_fidelity_sweep(
        port._h0, torch.as_tensor(port.lbfgs_controllers[str(N)]
                                  ["controller"][:4]),
        torch.as_tensor(noises), prng.key(0), 16, 0, 2,
        complex_offdiag=True, device="cpu").numpy()
    assert not np.allclose(other, fl)
