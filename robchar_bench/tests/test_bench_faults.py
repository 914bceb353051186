"""A run with the timed path broken underneath comes out not correct, a
sound run correct, and the control fails its cell's limits.

Each case skips the harness's look for a chip and drives the rest of a run
on the CPU (the port's plain versions in place of its kernels) at a size a
test run holds, with the cell's own configuration and limits."""

import time

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import lbfgs, objectives
from code_robchar_tpu_torch.ops import cuda_jacobi
from robchar_bench import harness

BENCH = harness.load_json(harness.bench_path())
SEED = 2**31 + 4242


def _mc_spec(cell):
    spec = harness.cell_spec(BENCH, cell)
    spec["config"]["mc"]["controllers"] = 4
    spec["mix"]["sample_cells"] = 24
    spec["mix"]["traced_units"] = 1
    return spec


def _zoo_spec(cell):
    spec = harness.cell_spec(BENCH, cell)
    mix = spec["mix"]
    mix.update(pool=32, warm_pool=8, save_topc=16, traced_units=1,
               sample_every=5)
    mix["options"] = {**mix.get("options", {}), "lane_width": 32,
                      "maxiter": 60}
    return spec


def _run(spec, trace=False):
    return harness.run_cell(spec, SEED, 0.01, trace, "cpu", time.perf_counter(),
                            log=lambda *a: None)


MC_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "mc"]
ZOO_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "lbfgs"]


@pytest.mark.parametrize("cell", MC_CELLS)
def test_mc_sound_run_is_correct(cell):
    res = _run(_mc_spec(cell))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", MC_CELLS)
def test_mc_half_the_reps_left_out_is_not_correct(cell, monkeypatch):
    real = engine.metric_tensors

    def half(fids, alpha=0.05):
        return real(fids[..., : fids.shape[-1] // 2], alpha)

    monkeypatch.setattr(engine, "metric_tensors", half)
    assert not _run(_mc_spec(cell))["correct"]


@pytest.mark.parametrize("cell", MC_CELLS)
def test_mc_answer_altered_is_not_correct(cell, monkeypatch):
    real = cuda_jacobi.fidelity_herm

    def altered(*args, **kwargs):
        f = real(*args, **kwargs).clone()
        f[::50] = 1.0 - f[::50]
        return f

    monkeypatch.setattr(cuda_jacobi, "fidelity_herm", altered)
    assert not _run(_mc_spec(cell))["correct"]


@pytest.mark.parametrize("cell", MC_CELLS)
def test_mc_control_fails_the_limits(cell):
    # the control replaces the program's outputs, so it needs no unit: the
    # cell's own controllers and sample, two units' keys
    spec = harness.cell_spec(BENCH, cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    inputs = driver.inputs(cfg, mix, SEED)
    control = driver.readings(cfg, mix, inputs, [None, None], control=True)
    assert not harness.passes(harness.judge(spec, control)), control


@pytest.mark.parametrize("cell", ZOO_CELLS)
def test_zoo_sound_run_is_correct(cell):
    res = _run(_zoo_spec(cell))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ZOO_CELLS)
def test_zoo_state_unchanged_is_not_correct(cell, monkeypatch):
    def frozen(x0_pool, key, value_and_grad_b, lower, upper, maxiter,
               maxfun, lanes=None, calls_per_eval=1):
        f, _, calls = value_and_grad_b(x0_pool, key)
        ones = torch.ones(len(x0_pool), dtype=torch.int32)
        return lbfgs._PoolResult(x0_pool.clone(), f, calls * ones, ones,
                                 1, 1, 1)

    monkeypatch.setattr(lbfgs, "_batched_restarts", frozen)
    res = _run(_zoo_spec(cell))
    assert not res["correct"]
    assert res["checks"]["unimproved"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ZOO_CELLS)
def test_zoo_answer_altered_is_not_correct(cell, monkeypatch):
    real = objectives.make_infidelity_batch

    def altered(spec):
        fn = real(spec)

        def infid(xs, key):
            e, calls = fn(xs, key)
            return e - 0.01 * (e > 0.02), calls
        return infid

    monkeypatch.setattr(objectives, "make_infidelity_batch", altered)
    assert not _run(_zoo_spec(cell))["correct"]


GRADIENT_FAULTS = {
    "time_dropped": lambda g: torch.cat([g[:, :-1], 0 * g[:, -1:]], 1),
    "rolled": lambda g: g.roll(1, dims=1),
    "halved": lambda g: 0.5 * g,
}


@pytest.mark.parametrize("fault", sorted(GRADIENT_FAULTS))
@pytest.mark.parametrize("cell", ZOO_CELLS)
def test_zoo_gradient_altered_is_not_correct(cell, fault, monkeypatch):
    real = objectives.make_exact_gradient_batch
    alter = GRADIENT_FAULTS[fault]

    def altered(spec):
        fn = real(spec)

        def vag(xs):
            e, g = fn(xs)
            return e, alter(g)
        return vag

    monkeypatch.setattr(objectives, "make_exact_gradient_batch", altered)
    res = _run(_zoo_spec(cell))
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > \
        res["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", ZOO_CELLS)
def test_zoo_control_fails_the_limits(cell):
    spec = _zoo_spec(cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = driver.setup(cfg, mix, SEED, "cpu")
    outs = [driver.unit(job, cfg, mix, 0)]
    control = driver.readings(cfg, mix, job.inputs, outs, control=True)
    assert not harness.passes(harness.judge(spec, control)), control


def test_result_line_is_well_formed():
    res = _run(_mc_spec(MC_CELLS[0]))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    traced = _run(_mc_spec(MC_CELLS[0]), trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(traced)[-1] == "checks"


PPO_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "ppo"]


def _ppo_spec(cell):
    spec = harness.cell_spec(BENCH, cell)
    # on the CPU the port's critic takes full precision (models/ppo.py), so
    # the reference follows it there
    spec["config"]["critic"]["operands"] = "float32"
    spec["mix"].update(agents=4, steps_per_epoch=40, train_pi_iters=6,
                       train_v_iters=6, save_topc=10)
    return spec


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_sound_run_is_correct(cell):
    res = _run(_ppo_spec(cell))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_state_unchanged_is_not_correct(cell, monkeypatch):
    from code_robchar_tpu_torch.models import ppo

    real = ppo.PPO_en._build_epoch_impl

    def frozen_epoch(self, *args):
        fn = real(self, *args)

        def epoch(st):
            st2, out = fn(st)
            return st2._replace(params=st.params, pi_opt=st.pi_opt,
                                vf_opt=st.vf_opt), out
        return epoch

    monkeypatch.setattr(ppo.PPO_en, "_build_epoch_impl", frozen_epoch)
    res = _run(_ppo_spec(cell))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["moment_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from code_robchar_tpu_torch.models import ppo

    real = ppo.policy_update

    def half(params, pi_opt, obs, act, adv, logp_old, **kw):
        h = obs.shape[1] // 2
        return real(params, pi_opt, obs[:, :h], act[:, :h], adv[:, :h],
                    logp_old[:, :h], **kw)

    monkeypatch.setattr(ppo, "policy_update", half)
    assert not _run(_ppo_spec(cell))["correct"]


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_answer_altered_is_not_correct(cell, monkeypatch):
    from code_robchar_tpu_torch.ops import rollout

    real = rollout.actor_env_rollout

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        fid = out.fid.clone()
        fid[::7] = 1.0 - fid[::7]
        return out._replace(fid=fid)

    monkeypatch.setattr(rollout, "actor_env_rollout", altered)
    assert not _run(_ppo_spec(cell))["correct"]


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_control_fails_the_limits(cell):
    # the control judges each epoch from the program's state, as the check
    # does, so it needs the unit's epochs
    spec = _ppo_spec(cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = driver.setup(cfg, mix, SEED, "cpu")
    outs = [driver.unit(job, cfg, mix, 0)]
    control = driver.readings(cfg, mix, job.inputs, outs, control=True)
    assert not harness.passes(harness.judge(spec, control)), control
