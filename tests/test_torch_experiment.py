"""The port's Experiment and drivers (code_robchar_tpu_torch/exp) against
the JAX package's: the cases of tests/test_experiment.py on the port (stub
models where that file uses them), the driver wiring of every command
(each command's recorded Experiment kwargs and calls equal to the JAX
drivers' for the same argv) and one real tiny collect on the CPU beside
the JAX package's (N=4, lbfgs and nmplus, 8 runs, a 600-call budget,
testing=True, float64)."""

import json
import os

import numpy as np
import pytest
import torch

from code_robchar_tpu.exp import Experiment as JExperiment
from code_robchar_tpu.exp import drivers as jdrivers
from code_robchar_tpu.mc import MCDataSim as JMCDataSim
from code_robchar_tpu.ops.propagate import fidelity_batch
from code_robchar_tpu_torch.exp import Experiment, ExperimentNamer, drivers
from code_robchar_tpu_torch.parallel import Mesh
from code_robchar_tpu_torch.exp.cli import (get_mcsim_args,
                                            get_noise_analysis_args)
from code_robchar_tpu_torch.exp.experiment import ModelDoesNotExistError
from code_robchar_tpu_torch.mc import MCDataSim


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**over):
    kw = dict(Nspin=4, inspin=0, outspin=2, fid_threshold=0.0,
              ham_noisy=True, noises=np.linspace(0, 0.1, 2),
              run_until_told_to_stop=True, run_until_completion_its=600,
              runs=8, records_update_rate=300, testing=True)
    kw.update(over)
    return kw


def small_exp(tmp_path, **over):
    return Experiment("pipeline_unit", global_dir=str(tmp_path /
                                                       "experiments"),
                      device="cpu", dtype=torch.float64, **_kw(**over))


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """One tiny collect of lbfgs and nmplus by each package (the store of
    tests/test_experiment.py's small_exp)."""
    root = tmp_path_factory.mktemp("collect")
    port = Experiment("pipeline_unit", global_dir=str(root / "port"),
                      device="cpu", dtype=torch.float64, **_kw())
    port.singlerun_ccollector(model_choices=["lbfgs", "nmplus"])
    jax = JExperiment("pipeline_unit", global_dir=str(root / "jax"), **_kw())
    jax.singlerun_ccollector(model_choices=["lbfgs", "nmplus"])
    return root, port, jax


def test_namer_path_convention(tmp_path):
    n = ExperimentNamer("exp1", Nspin=5, inspin=0, outspin=2,
                        numcontrollers=100,
                        global_dir=str(tmp_path / "experiments"))
    assert n.controller_store().endswith("exp1/ppo_spin_5_0-2_c_100")
    n()  # call form creates the home dir
    assert os.path.isdir(n.home)


def test_singlerun_ccollector_le_schema_and_mc_interop(collected):
    root, exp, _ = collected
    assert exp.filename.endswith(".le")
    data = json.load(open(exp.filename))
    # lbfgs keyed by str(Nspin); others by noise value
    assert list(data["lbfgs"]) == ["4"]
    assert list(data["nmplus"]) == ["0.0", "0.1"]
    ctrls = data["nmplus"]["0.0"]["controller"]
    assert len(ctrls[0]) == 5
    # the .le store feeds both packages' MCDataSim
    kw = dict(Nspin=4, inspin=0, outspin=2, noises=np.linspace(0, 0.1, 2),
              bootreps=3, numcontrollers=8, filemarker=".le",
              global_experiments_directory=str(root / "port"))
    sim = MCDataSim("pipeline_unit", device="cpu", dtype=torch.float64,
                    **kw)
    md = sim.get_metrics_dict("0.0", algoname="nmplus")
    assert "nmplus" in md
    jsim = JMCDataSim("pipeline_unit", **kw)
    np.testing.assert_array_equal(
        sim._controller_matrix("nmplus", "0.0"),
        jsim._controller_matrix("nmplus", "0.0"))
    np.testing.assert_allclose(
        np.asarray(md["nmplus"]["std"]),
        np.asarray(jsim.get_metrics_dict("0.0", algoname="nmplus")
                   ["nmplus"]["std"]), rtol=0, atol=1e-10)


def test_collect_beside_jax(collected):
    """The same store keys, cell counts and widths as the JAX package's.
    NM's whole runs agree with the JAX package's at this budget, so its
    controllers are held within 1e-10.  L-BFGS parts: its runs agree with
    the reference only for the first few iterations (rounding is
    amplified: the reference parts from itself as much with its starts
    moved by 1e-14),
    so each of its controllers is held at the fid_threshold or above by
    the JAX package's own noiseless fidelity; the parted runs end on the
    same optima (controllers ~1e-4 apart, fidelities ~1e-9), so the sorted
    fidelities of the two sets are held within 1e-6."""
    _, port, jax = collected
    a = json.load(open(port.filename))
    b = json.load(open(jax.filename))
    assert os.path.basename(port.filename) == os.path.basename(jax.filename)
    assert {k: list(v) for k, v in a.items()} == \
        {k: list(v) for k, v in b.items()}
    for algo in a:
        for key in a[algo]:
            ca = np.asarray(a[algo][key]["controller"])
            cb = np.asarray(b[algo][key]["controller"])
            assert ca.shape == cb.shape and ca.shape[1] == 5, (algo, key)
            assert len(ca) >= 1
    for key in a["nmplus"]:
        np.testing.assert_allclose(np.asarray(a["nmplus"][key]["controller"]),
                                   np.asarray(b["nmplus"][key]["controller"]),
                                   rtol=0, atol=1e-10)
    from code_robchar_tpu.ops.chain import xx_hamiltonian
    h0 = xx_hamiltonian(4)
    fa = np.asarray(fidelity_batch(h0, np.asarray(a["lbfgs"]["4"][
        "controller"]), 0, 2))
    fb = np.asarray(fidelity_batch(h0, np.asarray(b["lbfgs"]["4"][
        "controller"]), 0, 2))
    assert (fa >= port.fid_threshold).all()
    np.testing.assert_allclose(np.sort(fa), np.sort(fb), rtol=0, atol=1e-6)


def test_respawn_skips_completed_cells(tmp_path):
    exp = small_exp(tmp_path, respawn_from_checkpoint=True)
    exp.singlerun_ccollector(model_choices=["lbfgs"])
    data1 = json.load(open(exp.filename))

    exp2 = small_exp(tmp_path, respawn_from_checkpoint=True)
    exp2.singlerun_ccollector(model_choices=["lbfgs"])
    data2 = json.load(open(exp2.filename))
    # identical content: all cells were skipped on respawn
    assert data1 == data2


class _NoiseTaggedStub:
    """Model stub whose controllers encode the noise it was run at."""

    instances = []

    def __init__(self, **kw):
        self.kw = kw
        self.noise = None
        self.fid_threshold = None
        self.runs_done = 0
        _NoiseTaggedStub.instances.append(self)

    def run(self):
        self.runs_done += 1
        tag = float(self.noise)
        self.record = {
            "time_to_get_fid": 0.0, "func_calls": 1, "iterations": 1,
            "repeats": 1, "best_fid": 1.0,
            "controller": [tag] * 5,
            "controllers": [[tag] * 5, [tag] * 5],
        }
        self.records = {"300": [[tag] * 5]}


def test_lbfgs_cell_runs_first_noise_only_and_survives_respawn(tmp_path):
    """The lbfgs cell runs once, at the first noise level, and is skipped
    for every later noise, in memory and across a JSON respawn
    (noise_analysis.py:315-332)."""
    _NoiseTaggedStub.instances = []
    noises = np.asarray([0.0, 0.1])
    exp = small_exp(tmp_path, noises=noises)
    exp.init_chosen_models = lambda choices: {"lbfgs": _NoiseTaggedStub}
    exp.singlerun_ccollector(model_choices=["lbfgs"])

    assert sum(s.runs_done for s in _NoiseTaggedStub.instances) == 1
    # device and dtype reach the model
    (stub,) = _NoiseTaggedStub.instances
    assert stub.kw["device"] == "cpu" and stub.kw["dtype"] == torch.float64
    data = json.load(open(exp.filename))
    assert list(data["lbfgs"].keys()) == ["4"]  # keyed by str(Nspin)
    assert data["lbfgs"]["4"]["controller"][0][0] == 0.0

    _NoiseTaggedStub.instances = []
    exp2 = small_exp(tmp_path, noises=noises)
    exp2.init_chosen_models = lambda choices: {"lbfgs": _NoiseTaggedStub}
    exp2.singlerun_ccollector(model_choices=["lbfgs"])
    assert sum(s.runs_done for s in _NoiseTaggedStub.instances) == 0
    assert json.load(open(exp2.filename)) == data


def test_var_noise_lbfgs_first_noise_only(tmp_path):
    _NoiseTaggedStub.instances = []
    exp = small_exp(tmp_path, runs=3, noises=np.asarray([0.0, 0.1]))
    exp.init_chosen_models = lambda choices: {"lbfgs": _NoiseTaggedStub}
    exp.run_var_noise(model_choices=["lbfgs"])
    assert sum(s.runs_done for s in _NoiseTaggedStub.instances) == 3
    data = json.load(open(exp.filename))
    cell = data["lbfgs"]["4"]
    assert len(cell["controller"]) == 3
    assert all(c[0] == 0.0 for c in cell["controller"])


def test_var_noise_record_schema(tmp_path):
    exp = small_exp(tmp_path, runs=2,
                    run_until_told_to_stop=False, fid_threshold=0.2,
                    noises=np.asarray([0.05]))
    exp.run_var_noise(model_choices="nmplus")
    data = json.load(open(exp.filename))
    assert list(data["nmplus"]) == ["0.05"]
    cell = data["nmplus"]["0.05"]
    for k in ("time_to_get_fid", "func_calls", "iterations", "repeats",
              "best_fid", "controller"):
        assert k in cell
        assert len(cell[k]) == 2  # one entry per run
    assert all(f > 0.2 for f in cell["best_fid"])


def test_retry_budget_gives_up(tmp_path):
    exp = small_exp(tmp_path, runs=3, chances=2)
    tries = []

    class Boom:
        def __init__(self, **kw):
            tries.append(kw)
            raise RuntimeError("boom")

    exp.init_chosen_models = lambda choices: {"lbfgs": Boom}
    exp.run_var_noise(model_choices="lbfgs")  # must not raise
    data = json.load(open(exp.filename))
    assert data["lbfgs"] == {}
    # chances + 1 tries at each of the two noises (nothing was stored, so
    # the lbfgs cell is not done at the second), then give up
    assert len(tries) == 2 * (exp.chances + 1)
    with pytest.raises(ModelDoesNotExistError):
        Experiment.init_chosen_models(exp, ["gradient_descent"])


def test_nstoch_sampling_stores_checkpoints(tmp_path):
    exp = small_exp(tmp_path, noises=np.asarray([0.05]), runs=4,
                    run_until_completion_its=900, records_update_rate=300)
    exp.singlerun_ccollector_nstoch_sampling(model_choices=["snob"])
    assert exp.filename.endswith(".le_sh")
    data = json.load(open(exp.filename))
    cps = list(data["snob"].values())[0]
    assert len(cps) >= 1  # {fcalls: [controllers]} checkpoints
    first = list(cps.values())[0]
    assert len(first[0]) == 5
    assert exp.load() == data


def test_cli_flag_surface():
    args = get_noise_analysis_args([
        "--nspin", "4", "--outspin", "2", "--num_controllers", "10",
        "--fid_noisy", "False", "--ham_noisy", "True"])
    assert args.nspin == 4 and args.num_controllers == 10
    assert args.fid_noisy is False     # the type=bool trap, fixed
    assert args.ham_noisy is True
    m = get_mcsim_args(["--bootreps", "7", "--training_noise", "0.05"])
    assert m.bootreps == 7 and m.training_noise == "0.05"


def test_mesh_is_refused(tmp_path):
    """``mesh`` was refused until it was ported: it is now forwarded to
    every model (a PPO whose agent count it does not divide runs
    unsharded), as in the JAX package."""
    mesh = Mesh(["cpu"] * 2)
    exp = small_exp(tmp_path, mesh=mesh)
    assert exp.mesh is mesh
    inits = exp.init_chosen_models(["lbfgs", "nmplus", "ppo"])
    for name in ("lbfgs", "nmplus"):
        assert exp._make_model(inits, name, 0.0).mesh is mesh
    assert exp._make_model(inits, "ppo", 0.0).mesh is None
    exp.args["num_agents"] = 2
    assert exp._make_model(inits, "ppo", 0.0).mesh is mesh


class _RecordingExperiment:
    """Stub for exp.Experiment: records construction kwargs and which
    driver method ran, performs no compute."""

    instances = []

    def __init__(self, exp_name, **kw):
        self.exp_name = exp_name
        self.kw = kw
        self.calls = []
        type(self).instances.append(self)

    def __getattr__(self, name):
        def method(*a, **k):
            self.calls.append((name, a, k))
        return method


class _PortRecorder(_RecordingExperiment):
    instances = []


class _JaxRecorder(_RecordingExperiment):
    instances = []


def _canon(rec):
    kw = {k: (np.asarray(v).tolist() if k == "noises" else v)
          for k, v in rec.kw.items()}
    return rec.exp_name, kw, rec.calls


COMMANDS = {
    "collect": lambda d, **k: d.run_experiments_single_controller_set_with_le(
        ["--exp_name", "pipeline_c", "--nspin", "7", "--outspin", "6",
         "--num_controllers", "1000", "--fid_threshold", "0.1",
         "--noise_res", "3", "--max_noise", "0.1",
         "--run_until_completion_its", "5000"], **k),
    "var_noise":
        lambda d, **k: d.run_controller_getter_without_landscape_exploration(
            ["--exp_name", "pipeline_vn", "--nspin", "5", "--inspin", "0",
             "--outspin", "4", "--algo_name", "nmplus",
             "--num_controllers", "7", "--noise_res", "3",
             "--max_noise", "0.2", "--draws", "50"], **k),
    "arim_scaling": lambda d, **k: [d.run_arim_scaling_experiments(
        ["--nspin", "5", "--inspin", "0", "--outspin", "2",
         "--num_controllers", "100", "--run_until_completion_its",
         "40000000", "--records_update_rate", "100000",
         "--use_fixed_ham", fixed, "--fixed_ham_train_size", "100"], **k)
        for fixed in ("false", "true")],
    "ppo_test": lambda d, **k: d.run_ppo_test(**k),
    "paper_data": lambda d, **k: d.run_paper_data(budget=1234,
                                                  controllers=9, **k),
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_driver_wiring_equals_jax(command, monkeypatch):
    """Each command builds the same Experiments with the same kwargs and
    calls as the JAX package's drivers (noise grids compared by value);
    the port adds only ``device``, which the caller passes through."""
    _PortRecorder.instances, _JaxRecorder.instances = [], []
    monkeypatch.setattr(drivers, "Experiment", _PortRecorder)
    monkeypatch.setattr(jdrivers, "Experiment", _JaxRecorder)
    COMMANDS[command](drivers, device="cpu")
    COMMANDS[command](jdrivers)
    assert len(_PortRecorder.instances) == len(_JaxRecorder.instances) >= 1
    for p, j in zip(_PortRecorder.instances, _JaxRecorder.instances):
        assert p.kw.pop("device") == "cpu"
        assert _canon(p) == _canon(j)
    assert drivers.PAPER_TRANSITIONS == jdrivers.PAPER_TRANSITIONS
    assert set(drivers._COMMANDS) == set(jdrivers._COMMANDS)


def test_main_usage_and_dispatch(monkeypatch, capsys):
    monkeypatch.setattr(drivers.sys, "argv", ["drivers"])
    with pytest.raises(SystemExit) as e:
        drivers.main()
    assert e.value.code == 2
    assert "code_robchar_tpu_torch.exp.drivers" in capsys.readouterr().out
    seen = []
    monkeypatch.setitem(drivers._COMMANDS, "collect",
                        lambda argv: seen.append(argv))
    monkeypatch.setattr(drivers.sys, "argv", ["drivers", "collect",
                                              "--nspin", "4"])
    drivers.main()
    assert seen == [["--nspin", "4"]]
