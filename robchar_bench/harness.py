"""One run of one benchmark cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (a JSON file, ``configs``' ``file``) and a
traffic mix (``robchar_bench/traffic/<mix>.json``).  The mix names its
driver (``robchar_bench/drivers/<driver>.py``) and, under ``end_to_end``,
each end-to-end metric it reports besides ``setup_s``: the key of the
driver's ``work()`` that the metric counts over the window, and a
``scale`` (1 by default), so that a rate an hour is ``scale`` 3600.  Each
per-layer metric is a reader of its own (``robchar_bench/metrics/<name>.py``,
or, where no such file is, ``metrics/<prefix>.py`` for the part of the name
before its first dot, which one quantity split by cell shares); each cell's
limits are a file of their own (``robchar_bench/limits/<cell>.json``).  A
cell, a mix or a metric is added by adding files and entries, never by
editing a file.  A new cell also appends its name to the ``workloads``
list of each existing metric that it reports, in ``BENCHMARK.json``; no
other field of an existing entry changes.

A run: set-up (the driver makes the inputs from the seed and builds the
program's objects), a warm-up over every shape the cell uses, then a
closed loop of whole units (each unit one call of the entry the mix
drives, started when the previous one has returned its results to the
host) until ``seconds`` have passed.  The rate is the work of all those
units over the time from the window's start to the end of the last unit.
``trace=True`` instead profiles ``traced_units`` whole units, with the
driver's spans on where it has them (``instrument``), and reports the
per-layer metrics.  After the window the peak memory is read, the
program's objects are freed, and the reference judges the units' outputs.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional

import torch

from robchar_bench import trace as tracing

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(items: List[Dict], name: str, what: str) -> Dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(bench: Dict, workload: str) -> Dict:
    """Everything a run of ``workload`` reads: the cell, its configuration,
    its mix, its driver module, its end-to-end and per-layer metrics and
    its limits."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "configuration")
    mix = load_json(os.path.join(PACKAGE, "traffic", cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reported]
    limits_path = os.path.join(PACKAGE, "limits", workload + ".json")
    return {
        "cell": cell,
        "config": load_json(os.path.join(ROOT, conf["file"])),
        "mix": mix,
        "driver": importlib.import_module(
            f"robchar_bench.drivers.{mix['driver']}"),
        "end_to_end": e2e,
        "per_layer": layer,
        "limits": (load_json(limits_path)
                   if os.path.exists(limits_path) else {}),
    }


def reader(name: str):
    """The ``read(ctx)`` function of per-layer metric ``name``: from
    ``metrics/<name>.py``, else from ``metrics/<prefix>.py``."""
    path = os.path.join(PACKAGE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(PACKAGE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "robchar_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _total(driver, cfg, mix, outs) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for out in outs:
        for k, v in driver.work(cfg, mix, out).items():
            total[k] = total.get(k, 0.0) + v
    return total


def judge(spec: Dict, readings: Dict[str, float]) -> Dict[str, Dict]:
    """The readings that the cell's limits name, each beside its limit;
    without a limits file, every reading beside None, which fails."""
    limits = spec["limits"]
    if not limits:
        return {name: {"value": value, "limit": None}
                for name, value in readings.items()}
    return {name: {"value": readings[name], "limit": limits[name]["limit"]}
            for name in limits}


def passes(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())


def prepare(spec: Dict, seed: int, device, warm: bool = True):
    """The set-up of a run: the driver's job from the seed, warmed up over
    the cell's shapes unless ``warm`` is False."""
    device = torch.device(device)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = driver.setup(cfg, mix, seed, device)
    if warm:
        driver.warm(job, cfg, mix)
    _sync(device)
    return job


def rates(spec: Dict, work: Dict[str, float], elapsed: float,
          setup_s: float) -> Dict[str, float]:
    """The cell's end-to-end metrics: ``setup_s``, and each metric that the
    mix declares as its work key over the window, times its scale."""
    declared = spec["mix"]["end_to_end"]
    out = {}
    for m in spec["end_to_end"]:
        if m["name"] == "setup_s":
            out["setup_s"] = setup_s
        else:
            d = declared[m["name"]]
            out[m["name"]] = work[d["work"]] * d.get("scale", 1) / elapsed
    return out


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool,
             device, t0: float, log=print) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    job = prepare(spec, seed, device)

    outs: List = []
    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    start = time.perf_counter()
    setup_s = start - t0
    if not trace:
        while True:
            outs.append(driver.unit(job, cfg, mix, len(outs)))
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
    else:
        if hasattr(driver, "instrument"):
            driver.instrument(job)
        with tracing.profiled(device) as box:
            start = time.perf_counter()
            for u in range(mix["traced_units"]):
                outs.append(driver.unit(job, cfg, mix, u))
            elapsed = time.perf_counter() - start
        tr = box[0]
    work = _total(driver, cfg, mix, outs)
    values = rates(spec, work, elapsed, setup_s)
    log(f"units {len(outs)} in {elapsed:.4f} s: {values!r}"
        + (" (traced)" if trace else "") + f"; work {work}")
    if not trace:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"trace": tr, "work": work, "config": cfg, "mix": mix,
               "job": job, "outs": outs}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["busy_s"] = tr.busy_us() / 1e6
        extra["window_s"] = tr.window_us / 1e6
        extra["breakdown"] = tr.breakdown()
        del ctx, tr

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    inputs = job.inputs
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(not driver.valid(cfg, out) for out in outs)
    start = time.perf_counter()
    readings = driver.readings(cfg, mix, inputs, outs)
    log(f"reference check {time.perf_counter() - start:.1f} s")
    checks = judge(spec, readings)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = extra["busy_s"]
        dev["window_s"] = extra["window_s"]
    result = {"correct": failed == 0 and passes(checks),
              "attempted": len(outs), "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    return result


def forbidden_modules(names, forbidden) -> List[str]:
    """The top-level names among module names ``names`` (the part before
    the first dot, compared whole) that are in ``forbidden``."""
    return sorted({n.split(".")[0] for n in names} & set(forbidden))


def bench_path(root: Optional[str] = None) -> str:
    return os.path.join(root or ROOT, "BENCHMARK.json")
