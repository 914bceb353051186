"""Where a benchmark cell's device sits idle, by program span: each idle
interval of the traced units put down to the innermost span of the port
(code_robchar_tpu_torch/utils/trace.py) that covers it.

    python3 tools/span_idle.py --workload mc.xx7_0to6 --seed 2147483900
        [--workload ...] [--device cuda] [--out FILE]

Run from the repository root.  For each cell: the benchmark's set-up and
warm-up (robchar_bench.harness.prepare), then its ``traced_units`` under
the benchmark's profiler (robchar_bench.trace.profiled), as ``python3 -m
robchar_bench.run --trace 1`` runs them.  The idle intervals are the
window less the union of the device's intervals.  Spans on one host thread
nest, so a sweep over their starts and ends with a stack labels every
instant with the innermost open span; an idle instant under none is
``(no span)``.  Unlike the benchmark's ``breakdown``, which labels a
whole gap by the host event at its midpoint found within 64 events, this
uses every span and splits a gap where spans start or end inside it.

One JSON line a cell: the traced rate (the cell's work over the traced
units' wall), the window, busy and idle seconds, the idle seconds by span
(the longest first), the share of idle time inside a span other than the
cell's root span, and a clock check: the spans' extent against the window
and the share of device time that lies inside a root span (device work
the host enqueued under a span runs after the span opened, so a shared
clock puts nearly all of it there).  ``--out`` appends the lines to FILE.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the first word of every span name of the port
PREFIXES = ("mc.", "zoo.", "lbfgs.", "ppo.", "record.")
#: the spans that open an entry call
ROOTS = ("mc.sweep", "zoo.run", "ppo.run")
NO_SPAN = "(no span)"


def union(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(device, window):
    """The parts of ``window`` in which no device interval runs."""
    t0, t1 = window
    out, t = [], t0
    for s, e in union((s, e) for _, s, e in device):
        if s > t:
            out.append((t, min(s, t1)))
        t = max(t, e)
        if t >= t1:
            break
    if t < t1:
        out.append((t, t1))
    return [(s, e) for s, e in out if e > s]


def innermost(spans, window):
    """(start, end, name) pieces of ``window``, each labelled with the
    innermost span covering it (``NO_SPAN`` where none does).  ``spans``
    nest: each lies inside or outside each other one."""
    t0, t1 = window
    out, stack = [], []
    t = t0

    def emit(upto):
        nonlocal t
        upto = min(upto, t1)
        if upto > t:
            out.append((t, upto, stack[-1][0] if stack else NO_SPAN))
            t = upto

    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            emit(stack[-1][2])
            stack.pop()
        emit(s)
        stack.append((name, s, e))
    while stack:
        emit(stack[-1][2])
        stack.pop()
    emit(t1)
    return out


def overlap_by_label(pieces, intervals):
    """Seconds of ``intervals`` (us, sorted, disjoint) under each label of
    ``pieces`` (us, sorted, disjoint)."""
    out = collections.defaultdict(float)
    j = 0
    for s, e, name in pieces:
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < e:
            lo, hi = max(s, intervals[k][0]), min(e, intervals[k][1])
            if hi > lo:
                out[name] += (hi - lo) / 1e6
            k += 1
    return dict(out)


def attribute(tr):
    """The idle attribution and clock check of one ``Trace``."""
    spans = [ev for ev in tr.host if ev[0].startswith(PREFIXES)]
    idle = idle_intervals(tr.device, tr.window)
    by_span = overlap_by_label(innermost(spans, tr.window), idle)
    idle_s = sum(e - s for s, e in idle) / 1e6
    inner = sum(v for k, v in by_span.items()
                if k != NO_SPAN and k not in ROOTS)
    roots = union((s, e) for name, s, e in spans if name in ROOTS)
    dev = union((s, e) for _, s, e in tr.device)
    dev_s = sum(e - s for s, e in dev) / 1e6
    under_root = sum(overlap_by_label(
        [(s, e, "root") for s, e in roots], dev).values())
    return {
        "window_s": tr.window_us / 1e6, "busy_s": tr.busy_us() / 1e6,
        "idle_s": idle_s,
        "idle_by_span_s": sorted(by_span.items(), key=lambda kv: -kv[1]),
        "idle_share_in_inner_spans": inner / idle_s if idle_s else None,
        "spans": len(spans),
        "spans_from_window_start_s": (
            (min(s for _, s, _ in spans) - tr.window[0]) / 1e6
            if spans else None),
        "spans_to_window_end_s": (
            (tr.window[1] - max(e for _, _, e in spans)) / 1e6
            if spans else None),
        "device_share_under_roots": under_root / dev_s if dev_s else None,
    }


def run(cell, seed, device):
    from robchar_bench import harness
    from robchar_bench import trace as tracing

    spec = harness.cell_spec(harness.load_json(harness.bench_path()), cell)
    cfg, mix, driver = spec["config"], spec["mix"], spec["driver"]
    job = harness.prepare(spec, seed, device)
    if hasattr(driver, "instrument"):
        driver.instrument(job)
    outs = []
    with tracing.profiled(torch.device(device)) as box:
        start = time.perf_counter()
        for u in range(mix["traced_units"]):
            outs.append(driver.unit(job, cfg, mix, u))
        elapsed = time.perf_counter() - start
    work = {}
    for out in outs:
        for k, v in driver.work(cfg, mix, out).items():
            work[k] = work.get(k, 0.0) + v
    tr = box[0]
    row = {"workload": cell, "seed": seed, "units": len(outs),
           "elapsed_s": elapsed,
           "traced_rates": {k: v / elapsed for k, v in work.items()}}
    row.update(attribute(tr))
    row["breakdown_idle_gaps"] = tr.breakdown()["idle_gaps"]
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    for cell in args.workload:
        line = json.dumps(run(cell, args.seed, args.device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
