"""Program spans (code_robchar_tpu_torch/utils/trace.py) on the port's hot
loops, on the CPU.

Without a profiler ``span`` hands out one shared no-op context, and the MC
sweep, an L-BFGS pool and a PPO run give the same outputs, bit for bit,
with and without a profiler.  Under ``torch.profiler`` each span is a
host annotation: one ``mc.chunk`` a chunk with the chunk's draws, kernel
and reduction inside it; one ``lbfgs.trial`` and ``lbfgs.sync`` for each
trial and host sync that ``opt.stats`` counts; one ``ppo.epoch`` an epoch
holding its stage spans, with ``record.offers`` inside ``ppo.run``; and
``PPO_en.stage_hook`` still sees the same stage names in the same order.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import LBFGS, PPO_en
from code_robchar_tpu_torch.ops import chain, prng
from code_robchar_tpu_torch.utils import trace

#: the prefixes of the port's span names
PREFIXES = ("mc.", "zoo.", "lbfgs.", "ppo.", "record.")
#: stage_hook's names an epoch (no Wasserstein targets)
STAGES = ["start", "rollout", "true_fid", "values", "pi", "critic"]
PPO_EPOCHS = 2


def _spans(prof):
    """(name, start_ns, end_ns) of the port's spans in a closed profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(PREFIXES) and ev.is_user_annotation():
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return sorted(out, key=lambda sp: (sp[1], -sp[2]))


def _parent(spans, child):
    """The name of the innermost span enclosing ``child``, or None."""
    best = None
    for sp in spans:
        if sp is not child and sp[1] <= child[1] and child[2] <= sp[2] \
                and (best is None or sp[1] >= best[1]):
            best = sp
    return None if best is None else best[0]


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _mc():
    rng = np.random.default_rng(5)
    ctrl = np.column_stack([rng.uniform(-10, 10, (5, 4)),
                            rng.uniform(0, 30, 5)])
    return engine.mc_metric_sweep(
        chain.xx_hamiltonian_real(4, dtype=torch.float64), ctrl,
        np.array([0.0, 0.05]), prng.key(11), 8, 0, 2, chunk=24,
        device="cpu")


def _lbfgs():
    opt = LBFGS(4, 0, 2, testing=True, seed=7, repeats=16,
                restart_batch=16, lane_width=8, maxiter=6,
                fid_threshold=0.0, run_until_told_to_stop=True,
                run_until_completion_its=10**9, landscape_exploration=True,
                save_topc=10, device="cpu", dtype=torch.float64)
    opt.run()
    rec = {k: v for k, v in opt.record.items() if k != "time_to_get_fid"}
    return rec, dict(opt.stats)


def _ppo():
    ppo = PPO_en(4, 0, 2, testing=True, num_agents=8, ham_noisy=True,
                 landscape_exploration=True, save_topc=10,
                 run_until_told_to_stop=True,
                 run_until_completion_its=10**15, device="cpu",
                 dtype=torch.float64)
    seen = []
    ppo.stage_hook = seen.append
    ppo.run(seed=3, epochs=PPO_EPOCHS, steps_per_epoch=16,
            train_pi_iters=3, train_v_iters=3)
    rec = {k: v for k, v in ppo.record.items() if k != "time_to_get_fid"}
    return rec, seen


@pytest.fixture(scope="module")
def runs():
    """Each workload without a profiler, then under one."""
    out = {}
    for name, fn in (("mc", _mc), ("lbfgs", _lbfgs), ("ppo", _ppo)):
        plain = fn()
        traced, spans = _traced(fn)
        out[name] = (plain, traced, spans)
    return out


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("mc.chunk") is trace.span("ppo.epoch") is trace._OFF
    with trace.span("mc.chunk"):
        pass

    @trace.spanned("mc.sweep")
    def fold(key, data):
        """Folds."""
        return prng.fold_in(key, data)

    # a spanned function is the function: name, docstring, result
    assert (fold.__name__, fold.__doc__) == ("fold", "Folds.")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("x") is not trace._OFF
        with trace.span("mc.chunk"):
            key = fold(prng.key(1), 2)
    assert torch.equal(key, prng.fold_in(prng.key(1), 2))
    names = [sp[0] for sp in _spans(prof)]
    assert names == ["mc.chunk", "mc.sweep"]


def test_mc_sweep_equal_with_and_without_profiler(runs):
    plain, traced, _ = runs["mc"]
    assert sorted(plain) == sorted(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_lbfgs_pool_equal_with_and_without_profiler(runs):
    plain, traced, _ = runs["lbfgs"]
    assert plain == traced


def test_ppo_run_equal_with_and_without_profiler(runs):
    plain, traced, _ = runs["ppo"]
    assert plain == traced


def test_mc_spans_one_chunk_each_with_its_stages(runs):
    spans = runs["mc"][2]
    # 10 cells of 8 reps, 3 cells a 24-element chunk: 4 chunks
    chunks = _named(spans, "mc.chunk")
    assert len(chunks) == 4
    assert [sp[0] for sp in spans if _parent(spans, sp) is None] == \
        ["mc.sweep"]
    for name in ("mc.draws", "mc.kernel", "mc.reduce"):
        own = _named(spans, name)
        assert len(own) == 4, name
        assert all(_parent(spans, sp) == "mc.chunk" for sp in own), name
    assert all(_parent(spans, sp) == "mc.sweep" for sp in chunks)
    gather = _named(spans, "mc.gather")
    assert len(gather) == 1 and _parent(spans, gather[0]) == "mc.sweep"


def test_lbfgs_spans_count_the_trials_and_syncs(runs):
    (_, stats), spans = runs["lbfgs"][1], runs["lbfgs"][2]
    trials = _named(spans, "lbfgs.trial")
    rounds = _named(spans, "lbfgs.round")
    assert len(trials) == stats["trials"] > 0
    assert len(_named(spans, "lbfgs.sync")) == stats["syncs"]
    assert len(rounds) == stats["rounds"]
    assert all(_parent(spans, sp) == "lbfgs.round" for sp in trials)
    assert all(_parent(spans, sp) in ("lbfgs.trial", "zoo.batch")
               for sp in _named(spans, "lbfgs.sync"))
    for name in ("zoo.batch", "zoo.fetch", "record.offers", "record.save"):
        own = _named(spans, name)
        assert own and all(_parent(spans, sp) == "zoo.run" for sp in own), \
            name
    assert [sp[0] for sp in spans if _parent(spans, sp) is None] == \
        ["zoo.run"]


def test_ppo_spans_one_epoch_each_with_its_stages(runs):
    (_, seen), spans = runs["ppo"][1], runs["ppo"][2]
    epochs = _named(spans, "ppo.epoch")
    assert len(epochs) == PPO_EPOCHS
    assert all(_parent(spans, sp) == "ppo.run" for sp in epochs)
    for stage in ("rollout", "true_fid", "values", "pi", "critic"):
        own = _named(spans, "ppo." + stage)
        assert len(own) == PPO_EPOCHS, stage
        assert all(_parent(spans, sp) == "ppo.epoch" for sp in own), stage
    gae = _named(spans, "ppo.gae")
    assert len(gae) == PPO_EPOCHS
    assert all(_parent(spans, sp) == "ppo.values" for sp in gae)
    for name in ("ppo.fetch", "record.offers", "record.save"):
        own = _named(spans, name)
        assert len(own) == PPO_EPOCHS, name
        assert all(_parent(spans, sp) == "ppo.run" for sp in own), name
    assert [sp[0] for sp in spans if _parent(spans, sp) is None] == \
        ["ppo.run"]


def test_stage_hook_sees_the_same_stages(runs):
    plain, traced, _ = runs["ppo"]
    assert plain[1] == traced[1] == STAGES * PPO_EPOCHS


def test_stopwatch_and_timed_print_as_before_and_open_spans():
    lines = []
    watch = trace.Stopwatch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.timed("sweep", printer=lines.append):
            for _ in range(2):
                with watch.section("chunk"):
                    torch.ones(3).sum()
    assert re.fullmatch(r"\[sweep\] \d+\.\d{3}s", lines[0]), lines
    assert re.fullmatch(r"chunk: \d+\.\d{3}s / 2 calls", watch.report())
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.is_user_annotation()]
    assert names.count("sweep") == 1 and names.count("chunk") == 2
    # and without a profiler the same lines
    lines.clear()
    with trace.timed("x", printer=lines.append):
        pass
    assert re.fullmatch(r"\[x\] \d+\.\d{3}s", lines[0])


def test_span_idle_tool_puts_idle_time_down_to_the_innermost_span():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import span_idle
    from robchar_bench.trace import Trace

    host = [("mc.sweep", 0, 100), ("mc.chunk", 10, 50), ("mc.draws", 10, 30),
            ("aten::add", 12, 14), ("mc.kernel", 30, 50),
            ("mc.chunk", 50, 90), ("mc.draws", 50, 70)]
    device = [("k1", 20, 35), ("k2", 60, 95), ("k3", 62, 64)]
    # idle: [0, 20) [35, 60) [95, 100) in us
    assert span_idle.idle_intervals(device, (0, 100)) == \
        [(0, 20), (35, 60), (95, 100)]
    got = span_idle.attribute(Trace(device, host, (0.0, 100.0)))
    by = dict(got["idle_by_span_s"])
    assert by == pytest.approx({"mc.sweep": 15e-6, "mc.draws": 20e-6,
                                "mc.kernel": 15e-6}, rel=1e-12)
    assert got["idle_s"] == pytest.approx(50e-6)
    assert got["idle_share_in_inner_spans"] == pytest.approx(35 / 50)
    # a window that starts inside a span, and time under no span
    pieces = span_idle.innermost([("zoo.run", -5, 40), ("lbfgs.trial", 5, 8)],
                                 (0, 50))
    assert pieces == [(0, 5, "zoo.run"), (5, 8, "lbfgs.trial"),
                      (8, 40, "zoo.run"), (40, 50, span_idle.NO_SPAN)]
