"""Tracing / profiling helpers (counterpart of
code_robchar_tpu/utils/trace.py).

The reference has no tracing (SURVEY.md §5 — tqdm + prints; its real cost
telemetry is function-call accounting, reproduced in the record protocol).
This module adds device-level observability on top:

- ``trace(logdir)``: context manager around torch.profiler (CPU and, where
  there is a card, CUDA activities); on exit it writes a Chrome trace
  ``trace_<time>_<pid>.json`` under ``logdir``.
- ``timed(tag)``: wall-clock section timer; it synchronises the device of
  each CUDA tensor among ``sync_on`` before it reads the clock, so the
  numbers hold the asynchronous launches' work.
- ``Stopwatch``: accumulating named timers for host-side loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


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
            yield
        finally:
            self.totals[tag] += time.perf_counter() - start
            self.counts[tag] += 1

    def report(self) -> str:
        lines = [f"{tag}: {tot:.3f}s / {self.counts[tag]} calls"
                 for tag, tot in sorted(self.totals.items())]
        return "\n".join(lines)
