"""What a traced run reads from ``torch.profiler``: the device's intervals,
the host's kernel launches, the device's busy time and the breakdown.

The profiler records the host's operations and runtime calls and, on a
card, every kernel, copy and fill the device ran (CUPTI).  ``Trace``
holds them as plain tuples once the profile has closed, so that each
per-layer reader (robchar_bench/metrics/) and the breakdown work from the
same numbers.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Tuple

import torch

#: the host's kernel launches, as the runtime names them
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
#: entries in each list of the breakdown
TOP = 10
#: the annotation that marks the profiled window
WINDOW = "bench.window"


def busy_us(spans) -> float:
    """Length of the union of the (start, end) intervals.  A copy of
    tools/profile_zoo.py:47-58 (``_busy_us``) on plain tuples."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


class Trace:
    """Events of one profiled window, times in microseconds on the
    profiler's clock.

    device: (name, start, end) of every device operation;
    host: (name, start, end) of every host event (operations, runtime
    calls, annotations);
    window: (start, end) of the profiled units, on the same clock."""

    def __init__(self, device, host, window):
        self.device: List[Tuple[str, float, float]] = device
        self.host: List[Tuple[str, float, float]] = host
        self.window = window

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def launches(self) -> int:
        return sum(name in LAUNCH_NAMES for name, _, _ in self.host)

    def kernels(self, pattern: str) -> List[Tuple[str, float, float]]:
        """The device operations whose name contains ``pattern``."""
        return [ev for ev in self.device if pattern in ev[0]]

    def busy_us(self) -> float:
        return busy_us((s, e) for _, s, e in self.device)

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time (summed by name) and
        the idle gaps between device operations, summed by the host event
        that was running halfway through each (the innermost one covering
        that instant), the longest first; seconds."""
        ops = collections.defaultdict(float)
        for name, s, e in self.device:
            ops[name] += (e - s) / 1e6
        gaps = collections.defaultdict(float)
        host = sorted(self.host, key=lambda ev: ev[1])
        starts = [s for _, s, _ in host]
        end = self.window[0]
        for _, s, e in sorted(self.device, key=lambda ev: ev[1]) + [
                ("", self.window[1], self.window[1])]:
            if s > end:
                gaps[self._host_at(host, starts, (s + end) / 2)] += \
                    (s - end) / 1e6
            end = max(end, e)
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}

    @staticmethod
    def _host_at(host, starts, t, walk: int = 64) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - walk, -1), -1):
            name, s, e = host[j]
            if e > t:
                return name
        return "host (no traced event)"


def _events(prof):
    """(device, host) event tuples of a closed profile, in microseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for ev in kineto.events():
            item = (ev.name(), ev.start_ns() / 1e3,
                    (ev.start_ns() + ev.duration_ns()) / 1e3)
            if ev.device_type() != DeviceType.CUDA:
                host.append(item)
            elif not ev.is_user_annotation():
                device.append(item)
        return device, host
    for ev in prof.events():
        item = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type != DeviceType.CUDA:
            host.append(item)
        elif item[0] != WINDOW:
            device.append(item)
    return device, host


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the body (host and, on a card, device activity); yields a
    list that holds the ``Trace`` once the body has ended.  The window is
    the body's wall, from a synchronised start to a synchronised end."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: list = []
    with profile(activities=acts) as prof:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.record_function(WINDOW):
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    dev, host = _events(prof)
    marks = [(s, e) for name, s, e in host if name == WINDOW]
    window = marks[0] if marks else (min(s for _, s, _ in host),
                                     max(e for _, _, e in host))
    out.append(Trace(dev, host, window))
