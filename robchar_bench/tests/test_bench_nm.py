"""The cells whose traffic is ``nm`` (drivers/nm.py): a sound run comes out
correct, a run with the timed path broken underneath does not, and the
TF32 control fails the cell's limits; and kernel 3's counts
(counts/sym_amp.py) equal the smoke runs'.

Each run skips the harness's look for a chip and drives the rest of a run
on the CPU (the port's plain versions in place of its kernels) at a size a
test run holds, with the cell's own configuration, evaluation budget and
limits."""

import sys
import time

import pytest
import torch

from code_robchar_tpu_torch.models import nmplus, objectives
from robchar_bench import harness
from robchar_bench import trace as tracing
from robchar_bench.counts import herm_jacobi, sym_amp

BENCH = harness.load_json(harness.bench_path())
SEED = 2**31 + 4244
NM_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "nm"]


def _nm_spec(cell):
    spec = harness.cell_spec(BENCH, cell)
    mix = spec["mix"]
    mix.update(pool=32, warm_pool=8, save_topc=16, traced_units=1,
               sample_every=5)
    mix["options"] = {**mix["options"], "lane_width": 32}
    return spec


def _run(spec):
    return harness.run_cell(spec, SEED, 0.01, False, "cpu",
                            time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_sound_run_is_correct(cell):
    res = _run(_nm_spec(cell))
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"best_gap", "unimproved", "unmoved",
                                  "value_gap"}


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_state_unchanged_is_not_correct(cell, monkeypatch):
    def frozen(simplex0_pool, key, infid_b, lower, upper, maxfev, **kw):
        x0 = simplex0_pool[:, 0]
        f, _ = infid_b(x0, key)
        ones = torch.ones(len(x0), dtype=torch.int32)
        return x0.clone(), f, ones, ones, {"rounds": 1, "syncs": 1}

    monkeypatch.setattr(nmplus, "_nm_while_batched", frozen)
    res = _run(_nm_spec(cell))
    assert not res["correct"]
    assert res["checks"]["unimproved"]["value"] == pytest.approx(1.0)
    assert res["checks"]["unmoved"]["value"] == 1.0


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_half_the_pool_unchanged_is_not_correct(cell, monkeypatch):
    """Half the restarts come back at their starts, the rest searched: the
    best of the pool still comes from searched restarts."""
    real = nmplus.NMPlus._run_batch

    def half(self, x0s, keys):
        res = real(self, x0s, keys)
        x = res.x.clone()
        x[::2] = x0s[::2]
        return res._replace(x=x)

    monkeypatch.setattr(nmplus.NMPlus, "_run_batch", half)
    res = _run(_nm_spec(cell))
    assert not res["correct"]
    assert res["checks"]["unmoved"]["value"] > \
        res["checks"]["unmoved"]["limit"]
    assert res["checks"]["unimproved"]["value"] <= \
        res["checks"]["unimproved"]["limit"]


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_best_fidelity_altered_is_not_correct(cell, monkeypatch):
    real = nmplus.NMPlus._run_batch

    def altered(self, x0s, keys):
        res = real(self, x0s, keys)
        return res._replace(fid=res.fid - 1e-3)

    monkeypatch.setattr(nmplus.NMPlus, "_run_batch", altered)
    res = _run(_nm_spec(cell))
    assert not res["correct"]
    assert res["checks"]["best_gap"]["value"] > \
        res["checks"]["best_gap"]["limit"]


INFIDELITY_FAULTS = {
    "scaled": lambda e: e * (1 + 1e-3),
    "shifted_at_the_top": lambda e: e - 0.01 * (e > 0.02),
}


@pytest.mark.parametrize("fault", sorted(INFIDELITY_FAULTS))
@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_kernel3_values_altered_are_not_correct(cell, fault,
                                                   monkeypatch):
    real = objectives.make_infidelity_batch
    alter = INFIDELITY_FAULTS[fault]

    def altered(spec):
        fn = real(spec)

        def infid(xs, key):
            e, calls = fn(xs, key)
            return alter(e), calls
        return infid

    monkeypatch.setattr(objectives, "make_infidelity_batch", altered)
    res = _run(_nm_spec(cell))
    assert not res["correct"]
    assert res["checks"]["value_gap"]["value"] > \
        res["checks"]["value_gap"]["limit"]


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_control_fails_the_limits(cell):
    spec = _nm_spec(cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = driver.setup(cfg, mix, SEED, "cpu")
    outs = [driver.unit(job, cfg, mix, 0)]
    control = driver.readings(cfg, mix, job.inputs, outs, control=True)
    assert not harness.passes(harness.judge(spec, control)), control


@pytest.mark.parametrize("cell", NM_CELLS)
def test_nm_sampling_puts_the_builder_back(cell):
    """The wrapper stands in for ``make_infidelity_batch`` only while a
    batch builds its objective: after a unit the program's module holds
    its own builder again, and the kept calls are the objective's."""
    spec = _nm_spec(cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    real = objectives.make_infidelity_batch
    job = driver.setup(cfg, mix, SEED, "cpu")
    out = driver.unit(job, cfg, mix, 0)
    assert objectives.make_infidelity_batch is real
    assert out["kernel3"]
    lanes = mix["options"]["lane_width"] * (cfg["n"] + 2)
    for xs, errs in out["kernel3"]:
        assert xs.shape[0] == errs.shape[0] in (lanes, mix["pool"])
    work = driver.work(cfg, mix, out)
    assert work["evals"] == out["func_calls"]
    assert 0 < work["rounds"] < work["syncs"]
    assert sum(len(r.x) for r in out["batches"]) == mix["pool"]


def test_kernel3_counts_equal_the_smoke_runs():
    assert sym_amp.flops(7, 5) == 7919
    assert sym_amp.nbytes(7) == 208
    assert herm_jacobi.sweeps("float32", 7) == 5
    sys.path.insert(0, harness.ROOT)
    chip_smoke = pytest.importorskip("chip_smoke")
    for n in (5, 7, 10):
        assert sym_amp.flops(n, 5) == chip_smoke._amp_flops(n, 5)


def test_roofline_reader_counts_billed_evaluations():
    kernels = [("sym_jacobi_amp_group_kernel", 0.0, 100.0),
               ("sym_jacobi_amp_kernel", 200.0, 300.0),
               ("sym_jacobi_grad_group_kernel", 400.0, 900.0)]
    ctx = {"trace": tracing.Trace(kernels, [], (0.0, 1000.0)),
           "work": {"evals": 1e6, "restarts": 10.0},
           "config": {"n": 7, "dtype": "float32"}}
    read = harness.reader("sym_amp.roofline")
    bound = max(1e6 * 7919 / 67e12, 1e6 * 208 / 3.35e12)
    assert read(ctx) == pytest.approx(100.0 * bound / 200e-6, rel=1e-12)
    assert read({**ctx, "work": {"restarts": 10.0}}) is None
    assert read({**ctx, "trace": tracing.Trace([], [], (0.0, 1.0))}) is None


def test_launches_reader_is_the_zoo_arithmetic():
    host = [("cudaLaunchKernel", 0.0, 1.0)] * 30 + [("aten::add", 0, 2)]
    ctx = {"trace": tracing.Trace([], host, (0.0, 10.0)),
           "work": {"restarts": 4.0}}
    assert harness.reader("nm.launches_per_restart")(ctx) == 7.5
    assert harness.reader("nm.launches_per_restart")(ctx) == \
        harness.reader("zoo.launches_per_restart")(ctx)


def test_round_loop_readers_read_the_counters():
    ctx = {"trace": tracing.Trace([], [], (0.0, 1.0)),
           "work": {"evals": 1846102.0, "restarts": 8192.0,
                    "rounds": 1042.0, "syncs": 1042.0},
           "config": {"n": 7}, "mix": {"options": {"lane_width": 1024}}}
    lane_use = harness.reader("nm.lane_use")
    syncs = harness.reader("nm.syncs_per_restart")
    assert lane_use(ctx) == pytest.approx(
        100.0 * 1846102 / (1042 * 1024 * 9), rel=1e-12)
    assert syncs(ctx) == pytest.approx(1042 / 8192, rel=1e-12)
    bare = {**ctx, "work": {"evals": 1.0, "restarts": 1.0}}
    assert lane_use(bare) is None and syncs(bare) is None
