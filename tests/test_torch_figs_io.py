"""The port's figure caches, renders and utilities against the JAX
package's, on the CPU.

- fig 8's ``.pickle`` (a plain float64 ndarray) and ``.fckeys.json``
  sidecar: written by either package, loaded by the other with its sweep
  made to raise; the staleness rules (clean hit, legacy list sidecar,
  column signature, pre-sidecar pickle, changed fcall keys, a row count
  that the keys cannot label) give the same sweeps, keys, values, warnings
  and sidecars on both.
- utils.checkpoint: a PPO agent state round trip (bit-equal, its types
  kept), a template's devices, and a ``.pkl`` written by the JAX package's
  save_state.  utils.trace: ``timed`` and ``Stopwatch`` print what the JAX
  versions print; ``trace`` writes a Chrome trace.
- Each plot method renders its PDF (or PNG) at the size of
  tests/test_figs.py, and generate_all returns the JAX package's file
  basenames on a tiny store (the JAX run reads the port's caches with its
  sweep made to raise).  No test depends on ghostscript.

The JAX side's sweeps are the port's float64 sweep (a stub), as in
tests/test_torch_figs.py."""

import json
import os
import pickle
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

import code_robchar_tpu.figs as jfigs
from code_robchar_tpu.figs import generate_all as jgen
from code_robchar_tpu.mc import engine as jengine
from code_robchar_tpu.utils import checkpoint as jcheckpoint
from code_robchar_tpu.utils import trace as jtrace
import code_robchar_tpu_torch.figs as pfigs
from code_robchar_tpu_torch.figs import fig5 as pfig5
from code_robchar_tpu_torch.figs import generate_all as pgen
from code_robchar_tpu_torch.figs import rimk as primk
from code_robchar_tpu_torch.mc import engine as pengine
from code_robchar_tpu_torch.models import ppo
from code_robchar_tpu_torch.utils import checkpoint, trace

from test_torch_figs import port_sweep_stub

N, C, B = 4, 6, 8
NOISES = np.linspace(0, 0.1, 3)
SCALE_EXP = "pipeline_scalecov"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _controllers(rng, k=C, n=N):
    return np.column_stack([rng.uniform(-2, 2, (k, n)),
                            rng.uniform(1, 5, k)]).tolist()


# ------------------------------------------------------------ fig 8 cache

def _scaling(root, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    store = {"ppo": {"0.05": {"1000": _controllers(rng),
                              "2000": _controllers(rng)}}}
    home = root / "experiments" / SCALE_EXP
    home.mkdir(parents=True, exist_ok=True)
    for marker in ("sh", "nsh"):
        (home / f"ppo_spin_{N}_0-2_c_{C}.le_{marker}").write_text(
            json.dumps(store))
    return store


def _nstoch(pkg, root, port, bootreps=B):
    kw = dict(Nspin=N, inspin=0, outspin=2, noises=NOISES,
              bootreps=bootreps, numcontrollers=C, filemarker=".le", seed=0,
              fig_dir=str(root / "figs"),
              global_experiments_directory=str(root / "experiments"))
    if port:
        kw.update(device="cpu", dtype=torch.float64)
    return pkg.NStochOpt(SCALE_EXP, **kw)


class _Sweeps:
    """Counts the sweeps of both packages' fig 8: the port's own sweep,
    and the port's sweep standing in for the JAX package's."""

    def __init__(self, monkeypatch):
        self.port = self.jax = 0
        own = pengine.mc_fidelity_sweep
        stub = port_sweep_stub([])

        def port(*a, **k):
            self.port += 1
            return own(*a, **k)

        def jax(*a, **k):
            self.jax += 1
            return stub(*a, **k)

        monkeypatch.setattr(pfigs.fig8.engine, "mc_fidelity_sweep", port)
        monkeypatch.setattr(jfigs.fig8.engine, "mc_fidelity_sweep", jax)


def _save(sim):
    return sim.get_controller_name + "_arims_ppo0.05.pickle"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fig8_pickle_and_sidecar_load_across_packages(tmp_path, monkeypatch,
                                                      writer):
    sweeps = _Sweeps(monkeypatch)
    _scaling(tmp_path)
    port, jax = _nstoch(pfigs, tmp_path, True), _nstoch(jfigs, tmp_path,
                                                        False)
    src, dst = (port, jax) if writer == "port" else (jax, port)
    arims, keys = src.get_arims("ppo", "0.05", "", src.c_dict_sh)
    with open(_save(src), "rb") as f:
        stored = pickle.load(f)
    assert type(stored) is np.ndarray and stored.dtype == np.float64
    sidecar = json.loads(open(_save(src) + ".fckeys.json").read())
    assert sidecar == {"fckeys": ["1000", "2000"],
                       "cols": {"noises": [0.0, 0.05, 0.1],
                                "bootreps": B, "seed": 0}}
    assert (sweeps.port, sweeps.jax) == ((2, 0) if writer == "port"
                                         else (0, 2))
    got, got_keys = dst.get_arims("ppo", "0.05", "", dst.c_dict_sh)
    assert (sweeps.port, sweeps.jax) == ((2, 0) if writer == "port"
                                         else (0, 2))   # no new sweep
    np.testing.assert_array_equal(got, arims)
    assert got_keys == keys == ["1000", "2000"]


def _stale_case(sim, case, store):
    """Mutate the cache as ``case`` says; returns the cdict to ask with."""
    save = _save(sim)
    cdict = sim.c_dict_sh
    if case == "legacy_list":
        json.dump(["1000", "2000"], open(save + ".fckeys.json", "w"))
    elif case == "columns":
        json.dump({"fckeys": ["1000", "2000"],
                   "cols": {"noises": [0.0, 0.05, 0.1], "bootreps": B + 1,
                            "seed": 0}}, open(save + ".fckeys.json", "w"))
    elif case == "pre_sidecar":
        os.remove(save + ".fckeys.json")
    elif case == "fcall_keys":
        cdict = {"ppo": {"0.05": {"1000": store["ppo"]["0.05"]["1000"],
                                  "3000": store["ppo"]["0.05"]["2000"]}}}
    elif case == "row_count":
        os.remove(save + ".fckeys.json")
        with open(save, "wb") as f:
            pickle.dump(np.zeros((5, 3)), f)
    return cdict


@pytest.mark.parametrize("case", ["hit", "legacy_list", "columns",
                                  "pre_sidecar", "fcall_keys", "row_count"])
def test_fig8_staleness_rules_agree(tmp_path, monkeypatch, case):
    sweeps = _Sweeps(monkeypatch)
    out = {}
    for pkg, port in ((pfigs, True), (jfigs, False)):
        root = tmp_path / ("port" if port else "jax")
        store = _scaling(root)
        sim = _nstoch(pkg, root, port)
        sim.get_arims("ppo", "0.05", "", sim.c_dict_sh)
        before = sweeps.port + sweeps.jax
        cdict = _stale_case(sim, case, store)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            arims, keys = sim.get_arims("ppo", "0.05", "", cdict)
        keyfile = _save(sim) + ".fckeys.json"
        out[port] = dict(
            arims=arims, keys=keys,
            swept=sweeps.port + sweeps.jax - before,
            warned=[str(w.message).split(":", 1)[1] for w in caught
                    if "predates" in str(w.message)],
            sidecar=json.load(open(keyfile)) if os.path.exists(keyfile)
            else None)
    port, jax = out[True], out[False]
    np.testing.assert_allclose(port["arims"], jax["arims"], rtol=0,
                               atol=1e-10)
    for k in ("keys", "swept", "warned", "sidecar"):
        assert port[k] == jax[k], k
    want_swept = {"hit": 0, "legacy_list": 0, "columns": 2,
                  "pre_sidecar": 0, "fcall_keys": 2, "row_count": 0}
    assert port["swept"] == want_swept[case]
    assert bool(port["warned"]) == (case == "pre_sidecar")
    if case == "row_count":
        assert port["keys"] is None and port["arims"].shape == (5, 3)


# ------------------------------------------------------------- utilities

def _ppo_state():
    from code_robchar_tpu_torch.ops import prng

    p = ppo.PPO_en(4, 0, 2, testing=True, num_agents=4, device="cpu",
               dtype=torch.float64)
    return p._init_agent(prng.split(prng.key(0), 4))


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    return [x for v in state for x in _leaves(v)]


def test_checkpoint_round_trip_and_template(tmp_path):
    st = _ppo_state()
    path = checkpoint.save_state(str(tmp_path / "ck" / "agent"), st)
    assert path == str(tmp_path / "ck" / "agent") and os.path.isfile(path)
    back = checkpoint.restore_state(path)
    assert type(back) is type(st) and type(back.pi_opt) is type(st.pi_opt)
    assert set(back.params) == set(st.params)
    a, b = _leaves(st), _leaves(back)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # onto the template's devices (the meta device stands in for a card)
    meta = ppo.state_to(st, "meta")
    moved = checkpoint.restore_state(path, template=meta)
    assert all(t.device.type == "meta" for t in _leaves(moved))
    assert type(moved) is type(st)


def test_checkpoint_reads_jax_pickle(tmp_path, monkeypatch):
    """The JAX package's save_state falls back to a pickle of host arrays
    when orbax fails; the port's restore_state reads it as it is."""
    import orbax.checkpoint as ocp

    def broken(*a, **k):
        raise RuntimeError("orbax unavailable")

    monkeypatch.setattr(ocp, "StandardCheckpointer", broken)
    rng = np.random.default_rng(2)
    state = {"params": {"w": rng.normal(size=(3, 4)), "b": np.zeros(4)},
             "step": np.int32(7), "hist": [np.arange(3.0), 1.5]}
    out = jcheckpoint.save_state(str(tmp_path / "jax_ck"), state)
    assert out.endswith(".pkl")
    got = checkpoint.restore_state(str(tmp_path / "jax_ck"))
    want = jcheckpoint.restore_state(str(tmp_path / "jax_ck"))
    np.testing.assert_array_equal(got["params"]["w"], state["params"]["w"])
    np.testing.assert_array_equal(got["hist"][0], want["hist"][0])
    assert got["step"] == 7 and got["hist"][1] == 1.5


def test_timed_and_stopwatch_print_as_jax():
    pattern = re.compile(r"^\[sweep\] \d+\.\d{3}s$")
    for timed, sync in ((trace.timed, {"a": [torch.ones(3)]}),
                        (jtrace.timed, {"a": [np.ones(3)]}),
                        (trace.timed, None), (jtrace.timed, None)):
        lines = []
        with timed("sweep", sync_on=sync, printer=lines.append):
            pass
        assert len(lines) == 1 and pattern.match(lines[0]), lines
    watches = [trace.Stopwatch(), jtrace.Stopwatch()]
    for w in watches:
        for tag in ("b", "a", "b"):
            with w.section(tag):
                pass
        w.totals.update(a=0.25, b=1.5)
    assert watches[0].report() == watches[1].report() == \
        "a: 0.250s / 1 calls\nb: 1.500s / 2 calls"


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace.trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(tmp_path / "tr" / files[0]))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# --------------------------------------------------------------- renders

EXP = "pipeline_figcov"


@pytest.fixture(scope="module")
def render_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    rng = np.random.default_rng(3)
    home = root / "experiments" / EXP
    home.mkdir(parents=True)
    (home / f"ppo_spin_{N}_0-2_c_{C}.le").write_text(json.dumps(
        {"lbfgs": {str(N): {"controller": _controllers(rng)}},
         "ppo": {"0.0": {"controller": _controllers(rng)},
                 "0.05": {"controller": _controllers(rng)}}}))
    store = {algo: {nl: {"1000": _controllers(rng),
                         "2000": _controllers(rng)}
                    for nl in ("0.0", "0.05")}
             for algo in ("lbfgs", "ppo")}
    for marker in ("sh", "nsh"):
        (home / f"ppo_spin_{N}_0-2_c_{C}.le_{marker}").write_text(
            json.dumps(store))
    legacy = root / "noisy_analysis"
    legacy.mkdir()
    (legacy / f"lbfgs_spin_{N}_0-2_in").write_text(json.dumps(
        {"lbfgs": {str(N): {"controller": _controllers(rng)}}}))
    (legacy / f"ppo_spin_{N}_0-2_in").write_text(json.dumps(
        {"ppo": {"0.0": {"controller": _controllers(rng)},
                 "0.01": {"controller": _controllers(rng)}}}))
    return root


def _sim(cls, root, **kw):
    base = dict(Nspin=N, inspin=0, outspin=2, noises=NOISES, bootreps=B,
                numcontrollers=C, filemarker=".le", topk=4, device="cpu",
                dtype=torch.float64,
                global_experiments_directory=str(root / "experiments"))
    return cls(EXP, **dict(base, **kw))


def _render(name, root, out):
    fig = dict(fig_dir=str(out))
    if name == "fig3":
        return [_sim(pfigs.IndividualContComparisons, root, **fig)
                .plot_figs_3_6_10_11_12(noise_keys=["0.05"])]
    if name == "fig3e":
        return [_sim(pfigs.IndividualContComparisons, root, **fig)
                .plot_fig3e(noise_keys=["0.05"], fid_thres=0.2,
                            best_and_gt_fid_thres=True)]
    if name == "fig4":
        p, alt = _sim(pfigs.KTRConsistency, root, **fig).plot_kendalltaus(
            noise_keys=["0.05"])
        return [p, alt, p.replace("fig4.pdf", "fig4_combined.pdf")]
    if name == "fig7":
        return [_sim(pfigs.KTRConsistency, root, **fig)
                .plot_grouped_boxplots(noise_keys=["0.05"])]
    if name == "fig5":
        return [_sim(pfigs.ARIMGenerator, root, **fig).get_ARIM_plot(
            noise_keys=["0.05"])]
    if name == "fig5_grid":
        return [pfig5.paper_grid_plot(
            lambda n, o: _sim(pfigs.ARIMGenerator, root, **fig)
            if (n, o) == (N, 2) else None, fig_dir=str(out),
            noise_keys=["0.0", "0.05"])]
    if name == "fig8":
        return [_sim(pfigs.NStochOpt, root, **fig)
                .all_noises_combined_scaling_plot(nlvls=(0.0, 0.05))]
    if name == "fig1":
        ex = pfigs.CDFAreaExample(str(root / "noisy_analysis"), spin=N,
                                  inspin=0, outspin=2, bootreps=16,
                                  controllers=4, device="cpu",
                                  dtype=torch.float64)
        return ex.plot(np.linspace(0, 0.2, 3), max_panels=2,
                       outdir=str(out))
    x = _sim(primk.ExploringRIMK, root)
    if name == "rimk_arim":
        return x.exploring_rim_k(noise_index=1, topk=4, algo="ppo",
                                 save_dir=str(out))
    if name == "rimk_pairplot":
        paths, corr = x.exploring_rim_k(noise_index=1, topk=4, algo="ppo",
                                        arim=False, save_dir=str(out))
        assert corr.shape == (7, 7)
        return paths
    if name == "rimk_metrics":
        path, spears = x.exploring_metrics(noise_index=1, topk=4,
                                           save_dir=str(out))
        return [path, x.exploring_metrics(allnoisesplot=True, topk=4,
                                          save_dir=str(out))]
    assert name == "moments"
    primk.moments_vs_tails(fig_path=str(out / "mt.png"))
    return [str(out / "mt.png")]


@pytest.mark.parametrize("name", ["fig3", "fig3e", "fig4", "fig7", "fig5",
                                  "fig5_grid", "fig8", "fig1", "rimk_arim",
                                  "rimk_pairplot", "rimk_metrics",
                                  "moments"])
def test_plot_methods_render(render_root, tmp_path, name):
    paths = _render(name, render_root, tmp_path / name)
    assert paths
    for p in paths:
        assert os.path.isfile(p) and os.path.getsize(p) > 500, p


def _generate_store(root):
    rng = np.random.default_rng(4)
    keys = [str(k) for k in np.linspace(0, 0.1, 11)[:6]]
    home = root / "experiments" / "pipeline_gen"
    home.mkdir(parents=True)
    (home / f"ppo_spin_{N}_0-2_c_4.le").write_text(json.dumps(
        {"lbfgs": {str(N): {"controller": _controllers(rng, 4)}},
         "ppo": {k: {"controller": _controllers(rng, 4)} for k in keys}}))
    scaling = root / "experiments" / "pipeline_gen_scaling"
    scaling.mkdir()
    ck = {"ppo": {nl: {"1000": _controllers(rng, 100)}
                  for nl in ("0.01", "0.05", "0.1")}}
    for marker in ("sh", "nsh"):
        (scaling / f"ppo_spin_{N}_0-2_c_100.le_{marker}").write_text(
            json.dumps(ck))


def test_generate_all_basenames_match_jax(tmp_path, monkeypatch):
    """generate_all on a tiny store (N=4, 4 controllers, bootreps 2; fig 8
    one checkpoint of 100): the port's run writes every cache, the JAX
    package's run reads a copy of them with its sweep made to raise; both
    return the same file basenames."""
    _generate_store(tmp_path / "port")
    kw = dict(nspin=N, outspin=2, numcontrollers=4, bootreps=2,
              scaling_experiment="pipeline_gen_scaling",
              experiment_name="pipeline_gen")
    got = pgen.generate_all(str(tmp_path / "port" / "experiments"),
                            str(tmp_path / "port" / "figs"), device="cpu",
                            **kw)
    shutil.copytree(tmp_path / "port" / "experiments",
                    tmp_path / "jax" / "experiments")

    def boom(*a, **k):
        raise AssertionError("the JAX run swept a cached set again")

    monkeypatch.setattr(jengine, "mc_fidelity_sweep", boom)
    want = jgen.generate_all(str(tmp_path / "jax" / "experiments"),
                             str(tmp_path / "jax" / "figs"), **kw)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want]
    # 8 figures, then the 9 PDFs of the directory (with fig4_combined)
    # in gray
    assert "fig8_arim_scaling_all.pdf" in names and len(names) == 17
    assert all(os.path.getsize(p) > 500 for p in got)
