"""Wall-clock deadlines.

A copy of code_robchar_tpu/utils/timeout.py: framework-free host
code, which the port cannot import from the JAX package (importing any
of it pulls in jax).

The reference's failure-detection story is wall-clock timeouts raising
AssertionError inside optimizers (qnewton.py:620-629) plus a standalone
``timeout`` decorator (RLreinforce...:278-288).  Here one Deadline object
serves both; it raises a *dedicated* exception type so the orchestrator's
retry budget (exp/experiment.py) can distinguish timeouts from genuine
numerical failures while remaining an AssertionError subclass for
reference-compatible except clauses.
"""

from __future__ import annotations

import time
from typing import Callable


class TimeoutError_(AssertionError):
    """Raised when a Deadline expires (AssertionError subclass for parity
    with the reference's `raise AssertionError("timeout")`)."""


class Deadline:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = time.time()

    def remaining(self) -> float:
        return self.seconds - (time.time() - self.start)

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, context: str = "") -> None:
        if self.expired():
            raise TimeoutError_(f"timeout{': ' + context if context else ''}")


def timeout(seconds: float) -> Callable:
    """Decorator form: the wrapped callable raises once ``seconds`` have
    elapsed since decoration (matches the reference decorator's semantics —
    the clock starts at decoration time, not call time)."""
    def wrap(fn: Callable) -> Callable:
        dl = Deadline(seconds)

        def inner(*args, **kwargs):
            dl.check(fn.__name__)
            return fn(*args, **kwargs)
        return inner
    return wrap
