"""The ``ppo`` driver: PPO controller search of many agents at once through
the port's ``PPO_en.run()``.

Set-up builds one ``PPO_en`` on the configuration's chain (float32 on the
card) with the mix's agents, regime and top-c store, run until told to
stop with a function-call budget no unit reaches.  A unit is one
``run(seed_u, epochs)``: fresh agents from the unit's seed (seed_u, below),
then ``epochs`` epochs with ``run()``'s per-epoch host work (the record,
the top-c offers), as a user's search of that length runs.  Its work is
agents x steps x epochs environment steps.

The check judges the first unit's first ``check_epochs`` epochs with
reference/ppo.py.  A rollout parts from any other computation of it within
a few hundred steps (a rounding that moves a controller across the action
wrap or the time modulus sends that agent elsewhere), so the reference
judges each epoch from the program's own state at its start and from the
program's trajectory, step by step; the start is checked by itself (the
initial weights, worked out from the seed) and so are the draws (the
reference's own key chain).  The epochs are observed by wrapping the epoch
function ``run()`` builds: the wrapper keeps references to each checked
epoch's incoming state, outputs and outgoing parameters, and changes
nothing.  The readings (each the worst over the checked epochs):
``init_gap``, the largest relative gap of a leaf of the initial weights;
``reward_gap``, the widest gap of a reward from the fidelity at the
program's new controller; ``true_gap``, the same of the noiseless
fidelities; ``step_share``, the share of steps whose new controller parts
from the one the program's previous observation gives by more than 1e-3
(a wrap or a modulus that a rounding decides); ``change_gap``, by the
worst leaf, the gap between the norms of the program's and the
reference's parameter change over the epoch, over the larger of that
leaf's and the median leaf's norm (leaves whose first gradient in the
reference is under a thousandth of the median leaf's are left out: they
move by rounding alone); ``moment_gap``, the same measure of the two Adam
states (policy and critic, first and second moments, each set of leaves
with its own median) after the first epoch.

The first epoch starts from the reference's own optimizer states (optax's
initial ones), not the program's, and the program's states after it are
judged by ``moment_gap``; so the later epochs, which take the program's
states at their start, take states that were judged.  The unit's last
epoch (the third) is not judged: it runs the second's code on the second's
shapes, from a state handed over as the second's was, and judging it
would lengthen a check that already takes about as long as the window.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from robchar_bench.drivers import Job
from robchar_bench.reference import physics
from robchar_bench.reference import ppo as ref

#: the seed index of the warm-up unit (no unit of a window takes it)
WARM_UNIT = 2**32 - 1


def unit_seed(seed: int, u: int) -> int:
    """The seed of unit ``u``'s fresh agents: a 31-bit word of the run's
    seed and the unit's index."""
    return int(np.random.default_rng([int(seed), int(u)]).integers(2**31))


def setup(cfg: Dict, mix: Dict, seed: int, device) -> Job:
    models = importlib.import_module("code_robchar_tpu_torch.models")
    box = cfg["controller_box"]
    ppo = models.PPO_en(
        cfg["n"], cfg["in_site"], cfg["out_site"], bmin=box["bias"][0],
        bmax=box["bias"][1], max_time=box["time"][1], testing=True,
        ham_noisy=mix["ham_noisy"], noise=mix["noise"],
        lam=mix["lam"], gamma=mix["gamma"],
        landscape_exploration=True, save_topc=mix["save_topc"],
        run_until_told_to_stop=True, run_until_completion_its=10**15,
        num_agents=mix["agents"], rollout_sweeps=mix["rollout_sweeps"],
        device=torch.device(device), dtype=torch.float32)
    seen: Dict = {}
    build = ppo._build_epoch

    def observed_build(*args):
        fn = build(*args)

        def epoch_fn(st):
            st2, out = fn(st)
            if seen.get("open"):
                seen["epochs"].append((st, out, st2))
                seen["open"] = len(seen["epochs"]) < mix["check_epochs"]
            return st2, out
        return epoch_fn

    ppo._build_epoch = observed_build
    return Job({"seed": int(seed)}, {"ppo": ppo, "seen": seen})


def _run(job: Job, mix: Dict, u: int, epochs: int) -> Dict:
    ppo, seen = job.program["ppo"], job.program["seen"]
    if u == 0:
        seen.update(open=True, epochs=[])
    ppo.run(seed=unit_seed(job.inputs["seed"], u), epochs=epochs,
            steps_per_epoch=mix["steps_per_epoch"],
            clip_ratio=mix["clip_ratio"], pi_lr=mix["pi_lr"],
            vf_lr=mix["vf_lr"], max_ep_len=mix["max_ep_len"],
            train_pi_iters=mix["train_pi_iters"],
            train_v_iters=mix["train_v_iters"], target_kl=mix["target_kl"])
    rec = ppo.record
    out = {"u": u, "epochs": epochs, "best_fid": rec["best_fid"],
           "func_calls": rec["func_calls"],
           "controllers": np.asarray(rec.get("controllers") or [])}
    if u == 0:
        out["checked"] = seen.pop("epochs")
    return out


def instrument(job: Job) -> None:
    """CUDA events at the epoch's stage boundaries (``stage_hook``), one
    dict of them an epoch, for the traced run's per-layer metrics."""
    stages = job.program.setdefault("stages", [])

    def hook(name):
        if name == "start":
            stages.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        stages[-1][name] = ev

    if torch.device(job.program["ppo"].device).type == "cuda":
        job.program["ppo"].stage_hook = hook


def unit(job: Job, cfg: Dict, mix: Dict, u: int) -> Dict:
    return _run(job, mix, u, mix["epochs"])


def warm(job: Job, cfg: Dict, mix: Dict) -> None:
    _run(job, mix, WARM_UNIT, 1)


def work(cfg: Dict, mix: Dict, out) -> Dict[str, float]:
    return {"env_steps": float(mix["agents"] * mix["steps_per_epoch"]
                               * out["epochs"])}


def valid(cfg: Dict, out) -> bool:
    c = out["controllers"]
    return (out["best_fid"] is not None and np.isfinite(out["best_fid"])
            and c.ndim == 2 and c.shape[1] == cfg["n"] + 1
            and np.isfinite(c).all()
            and out["func_calls"] >= 0)


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _host(x):
    return x.detach().double().cpu().numpy()


def _params(tree, dev):
    return {k: v.detach().to(device=dev, dtype=torch.float64)
            for k, v in tree.items()}


def _opt(state, dev):
    return {"count": state.count.to(dev).long(),
            "mu": _params(state.mu, dev), "nu": _params(state.nu, dev)}


def _leaf_gap(got, want, keep):
    """By the worst leaf of ``keep``: the gap of norms of two parameter
    changes over the larger of the reference's and its median leaf's."""
    norm_ref = {k: float(np.linalg.norm(want[k])) for k in keep}
    med = float(np.median(list(norm_ref.values())))
    return max(abs(float(np.linalg.norm(got[k])) - norm_ref[k])
               / max(norm_ref[k], med) for k in keep)


def readings(cfg: Dict, mix: Dict, inputs: Dict, outs: List[Dict],
             control: bool = False) -> Dict[str, float]:
    """The readings of the module docstring; ``control`` puts the reference
    computed one precision below the configuration's (reference/ppo.py) in
    the program's place."""
    dev, n = _device(), cfg["n"]
    seed = unit_seed(inputs["seed"], 0)
    epochs = outs[0]["checked"]
    keys = ref.epoch_keys(seed, mix["agents"], len(epochs))
    crit = cfg["critic"]["operands"]
    p0 = ref.init_params(seed, mix["agents"], n, device=dev)[0]
    if control:
        got0 = {k: _host(ref.tf32(v)) for k, v in p0.items()}
    else:
        got0 = {k: _host(v) for k, v in epochs[0][0].params.items()}
    init_gap = max(float(np.linalg.norm(got0[k] - _host(v)))
                   / max(float(np.linalg.norm(_host(v))), 1e-30)
                   for k, v in p0.items())
    gaps = {"reward_gap": 0.0, "true_gap": 0.0, "step_share": 0.0,
            "change_gap": 0.0}
    moment_gap = float("inf")
    for e, ((st, out, st2), key) in enumerate(zip(epochs, keys)):
        params = _params(st.params, dev)
        if e == 0:
            opts = (ref.fresh_opt(params, "pi"), ref.fresh_opt(params, "v"))
        else:
            opts = (_opt(st.pi_opt, dev), _opt(st.vf_opt, dev))
        stores = np.swapaxes(_host(out.stores), 0, 1)        # (T, A, d)
        args = (params, _host(st.env.action), _host(st.env.timestep),
                st.ep_len.cpu().numpy().astype(np.int64), stores, key, cfg,
                mix, dev)
        ro = ref.rollout(*args)
        true = physics.controller_fidelity(
            physics.xx_chain(n), stores, cfg["in_site"], cfg["out_site"])
        rewards = _host(out.rewards).T
        new, first, _, states = ref.update(params, *opts, ro, rewards,
                                           stores, cfg, mix, dev,
                                           critic=crit)
        if control:
            ro_c = ref.rollout(*args, precision="tf32")
            got_r, got_o = ro_c.reward, ro_c.obs2
            got_t = physics.controller_fidelity(
                physics.xx_chain(n), stores, cfg["in_site"],
                cfg["out_site"], "tf32")
            new_c, _, _, states_c = ref.update(
                params, *opts, ro_c, rewards, stores, cfg, mix, dev, "tf32",
                crit)
            got_p = {k: _host(v) for k, v in new_c.items()}
            got_s = states_c
        else:
            got_r, got_o = rewards, stores
            got_t = _host(out.true_fids).T
            got_p = {k: _host(v) for k, v in st2.params.items()}
            got_s = {"pi": _opt(st2.pi_opt, dev), "vf": _opt(st2.vf_opt, dev)}
        med_grad = float(np.median(list(first.values())))
        keep = [k for k in params if first[k] >= 1e-3 * med_grad]
        before = {k: _host(v) for k, v in params.items()}
        step = np.abs(got_o - ro.obs2).max(-1) > 1e-3
        gaps["reward_gap"] = max(gaps["reward_gap"],
                                 float(np.abs(got_r - ro.reward).max()))
        gaps["true_gap"] = max(gaps["true_gap"],
                               float(np.abs(got_t - true).max()))
        gaps["step_share"] = max(gaps["step_share"], float(step.mean()))
        gaps["change_gap"] = max(gaps["change_gap"], _leaf_gap(
            {k: got_p[k] - before[k] for k in keep},
            {k: _host(new[k]) - before[k] for k in keep}, keep))
        if e == 0:
            moment_gap = max(
                _leaf_gap({k: _host(got_s[h][m][k]) for k in ks},
                          {k: _host(states[h][m][k]) for k in ks}, ks)
                for h in ("pi", "vf") for m in ("mu", "nu")
                for ks in [[k for k in keep if k in states[h][m]]])
    return {"init_gap": init_gap, **gaps, "moment_gap": moment_gap}
