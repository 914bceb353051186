"""Tracing / profiling helpers (counterpart of
code_robchar_tpu/utils/trace.py).

The reference has no tracing (SURVEY.md §5 — tqdm + prints; its real cost
telemetry is function-call accounting, reproduced in the record protocol).
This module adds host- and device-level observability on top:

- ``span(name)``: a program span.  While a torch profiler runs it is a
  ``torch.profiler.record_function`` annotation, so it lands in the same
  trace as the device operations it encloses, on their clock, with its
  name, start and end; its parent is the span enclosing it on the host
  thread.  While none runs it is a shared no-op context and costs one
  check of ``torch.autograd._profiler_enabled()``.  There is no switch:
  tracing is on exactly when a profiler is.  ``spanned(name)`` is the
  same span around every call of a function.
- ``trace(logdir)``: context manager around torch.profiler (CPU and, where
  there is a card, CUDA activities); on exit it writes a Chrome trace
  ``trace_<time>_<pid>.json`` under ``logdir``.
- ``timed(tag)``: wall-clock section timer; it synchronises the device of
  each CUDA tensor among ``sync_on`` before it reads the clock, so the
  numbers hold the asynchronous launches' work.
- ``Stopwatch``: accumulating named timers for host-side loops.

``timed`` and ``Stopwatch.section`` open ``span(tag)`` too.

An operator sees where a run's time goes with::

    from code_robchar_tpu_torch.utils import trace
    with trace.trace("traces"):
        engine.characterise(...)      # or opt.run(), ppo.run(...)

and opens the Chrome trace under ``traces/`` in Perfetto
(ui.perfetto.dev) or chrome://tracing: the port's spans nest over the
torch operations and kernel launches of their host thread, and the
device's kernels run beneath on the same time axis.

The spans sit at loop and layer boundaries, never per element:

- ``mc.sweep`` (``mc/engine.mc_metric_sweep`` / ``mc_fidelity_sweep``),
  per chunk ``mc.chunk`` with ``mc.draws`` (the keys' ``prng.fold_in`` and
  the assembly), ``mc.kernel`` (the fidelities) and ``mc.reduce`` (the
  metric tensors); ``mc.gather`` (the final concatenation);
- ``zoo.run`` (``ControlOptimizer.run``), ``zoo.batch`` (a dispatched
  batch), ``zoo.fetch`` (its copies to the host); in the L-BFGS restart
  loop ``lbfgs.round``, ``lbfgs.trial`` and ``lbfgs.sync`` (each host read
  of a device-side exit condition);
- ``ppo.run``, ``ppo.epoch`` with ``ppo.rollout``, ``ppo.true_fid``,
  ``ppo.values`` (holding ``ppo.gae``), ``ppo.wass_targets``, ``ppo.pi``
  and ``ppo.critic``; ``ppo.fetch`` (an epoch's copies to the host);
- ``record.offers`` (``TopControllers.offer_many``) and ``record.save``
  (``RunRecord.save``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


#: the context ``span`` hands out while no profiler runs
_OFF = contextlib.nullcontext()


def span(name: str):
    """A program span named ``name`` (module docstring): a profiler
    annotation while a torch profiler runs, else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _tensors(obj) -> Iterator[torch.Tensor]:
    """The tensors of a tensor, or of a dict, list or tuple of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
                    ".json"))


@contextlib.contextmanager
def timed(tag: str, sync_on: Optional[object] = None,
          printer=print) -> Iterator[None]:
    start = time.perf_counter()
    try:
        with span(tag):
            yield
    finally:
        for dev in {t.device for t in _tensors(sync_on) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        printer(f"[{tag}] {time.perf_counter() - start:.3f}s")


class Stopwatch:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, tag: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with span(tag):
                yield
        finally:
            self.totals[tag] += time.perf_counter() - start
            self.counts[tag] += 1

    def report(self) -> str:
        lines = [f"{tag}: {tot:.3f}s / {self.counts[tag]} calls"
                 for tag, tot in sorted(self.totals.items())]
        return "\n".join(lines)
