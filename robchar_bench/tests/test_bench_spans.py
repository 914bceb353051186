"""The readers of the program's spans (metrics/ with ``"source":
"program_span"``): each on a hand-built trace, and each in a traced run of
its cells on the CPU.  On the card, a traced unit with the spans enqueues
the same device operations and launches as with ``span`` stubbed out.

    python3 -m pytest robchar_bench/tests/test_bench_spans.py -q
"""

import contextlib
import time

import pytest
import torch

from robchar_bench import harness
from robchar_bench import trace as tracing

BENCH = harness.load_json(harness.bench_path())
SEED = 2**31 + 4243
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["source"] == "program_span"
                and m["name"] != "ppo.values_gae_ms"}
PPO_MIX = {"agents": 1024, "steps_per_epoch": 500}


def _trace(host):
    ends = [e for _, _, e in host] or [1.0]
    return tracing.Trace([], host, (0.0, max(ends)))


def _ctx(host, work, mix=None):
    return {"trace": _trace(host), "work": work, "mix": mix or {},
            "config": {}, "job": None, "outs": []}


# (metric, host events in us, work, mix, expected)
CASES = [
    ("mc.draws_ms_per_mham",
     [("mc.chunk", 0, 5000), ("mc.draws", 0, 1000), ("aten::add", 10, 20),
      ("mc.draws", 2000, 2500), ("mc.kernel", 2500, 4000)],
     {"hams": 2e6}, None, 1.5 / 2),
    ("zoo.sync_wait_us_per_restart",
     [("lbfgs.sync", 0, 30), ("lbfgs.trial", 30, 100),
      ("lbfgs.sync", 90, 100), ("lbfgs.synced", 0, 500)],
     {"restarts": 8.0, "grad_evals": 3.0}, None, 40 / 8),
    ("zoo.lane_use",
     [("lbfgs.trial", 0, 10), ("lbfgs.trial", 20, 30), ("lbfgs.round", 0, 40),
      ("lbfgs.sync", 10, 12)],
     {"restarts": 8.0, "grad_evals": 512.0}, {"options": {"lane_width": 1024}},
     100.0 * 512 / (2 * 1024)),
    ("ppo.offers_ms",
     [("ppo.run", 0, 9e6), ("record.offers", 1e6, 3e6),
      ("record.offers", 5e6, 6e6), ("record.save", 6e6, 6.1e6)],
     {"env_steps": 2 * 1024 * 500.0}, PPO_MIX, 3000.0 / 2),
    ("ppo.gae_host_ms",
     [("ppo.values", 0, 2e5), ("ppo.gae", 1e4, 9e4), ("ppo.gae", 3e5, 4e5),
      ("ppo.gae", 5e5, 5.2e5)],
     {"env_steps": 3 * 1024 * 500.0}, PPO_MIX, 200.0 / 3),
]


def test_every_span_metric_has_a_case():
    assert sorted(c[0] for c in CASES) == sorted(SPAN_METRICS)


@pytest.mark.parametrize("name,host,work,mix,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_reads_its_spans(name, host, work, mix, want):
    assert harness.reader(name)(_ctx(host, work, mix)) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,host,work,mix,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_reads_nothing_without_its_spans(name, host, work, mix, want):
    """A program without the spans (the parent of the change that added
    them) reads nothing, and so does a run without work."""
    own = {"mc.draws_ms_per_mham": "mc.draws",
           "zoo.sync_wait_us_per_restart": "lbfgs.sync",
           "zoo.lane_use": "lbfgs.trial", "ppo.offers_ms": "record.offers",
           "ppo.gae_host_ms": "ppo.gae"}[name]
    bare = [ev for ev in host if ev[0] != own]
    read = harness.reader(name)
    assert read(_ctx(bare, work, mix)) is None
    assert read(_ctx([("cudaLaunchKernel", 0, 5)], work, mix)) is None
    assert read(_ctx(host, {}, mix)) is None


def _tiny(cell):
    spec = harness.cell_spec(BENCH, cell)
    mix = spec["mix"]
    if mix["driver"] == "mc":
        spec["config"]["mc"]["controllers"] = 4
        mix.update(sample_cells=24, traced_units=1)
    elif mix["driver"] == "zoo":
        mix.update(pool=32, warm_pool=8, save_topc=16, traced_units=1,
                   sample_every=5)
        mix["options"] = {**mix.get("options", {}), "lane_width": 32,
                          "maxiter": 60}
    else:
        spec["config"]["critic"]["operands"] = "float32"
        mix.update(agents=4, steps_per_epoch=40, train_pi_iters=6,
                   train_v_iters=6, save_topc=10)
    return spec


@pytest.mark.parametrize("cell", sorted({c for m in SPAN_METRICS.values()
                                         for c in m["workloads"]}))
def test_traced_cpu_run_reads_every_span_metric(cell):
    spec = _tiny(cell)
    res = harness.run_cell(spec, SEED, 0.01, True, "cpu", time.perf_counter(),
                           log=lambda *a: None)
    want = {m["name"] for m in spec["per_layer"]
            if m["source"] == "program_span" and m["name"] in SPAN_METRICS}
    assert want and want <= set(res["metrics"]), res["metrics"]
    for name in want:
        value = res["metrics"][name]["value"]
        assert value > 0, (name, value)
        if SPAN_METRICS[name]["unit"] == "%":
            assert value <= 100.0, (name, value)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _device_ops(spec, stub, monkeypatch):
    """(device operations, launches) of one traced unit of ``spec`` on the
    card, with ``span`` stubbed out when ``stub``."""
    from code_robchar_tpu_torch.utils import trace as program_trace

    if stub:
        monkeypatch.setattr(program_trace, "span",
                            lambda name: contextlib.nullcontext())
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = harness.prepare(spec, SEED, "cuda")
    with tracing.profiled(torch.device("cuda")) as box:
        driver.unit(job, cfg, mix, 0)
    tr = box[0]
    names = {name for name, _, _ in tr.host}
    if not stub:
        assert names & {"mc.chunk", "lbfgs.trial"}
    else:
        assert not names & {"mc.chunk", "lbfgs.trial"}
    return len(tr.device), tr.launches()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mc.xx5_0to2", "lbfgs.xx7_0to6"])
def test_spans_add_no_device_operation_or_launch(card, cell, monkeypatch):
    """The same unit with spans and with ``span`` stubbed out launches the
    same kernels.  Two traced runs of one unit part by a few fills and
    copies (on the card, by up to 6 of the L-BFGS pool's ~148,000 device
    events, with spans on both sides), so the device events are held
    within 1e-4 of each other: a span that added one device event would
    add thousands (the pool opens ~12,000 spans)."""
    spec = harness.cell_spec(BENCH, cell)
    if spec["mix"]["driver"] == "zoo":
        spec["mix"].update(pool=2048, warm_pool=1024)
    with_spans = _device_ops(spec, False, monkeypatch)
    stubbed = _device_ops(spec, True, monkeypatch)
    assert with_spans[1] == stubbed[1]
    assert abs(with_spans[0] - stubbed[0]) <= 1e-4 * stubbed[0]
