"""The drivers: one module a kind of unit, named by a traffic mix's
``driver``.  Each exposes ``setup``, ``warm``, ``unit``, ``work``, ``valid``
and ``readings`` (robchar_bench/harness.py)."""

import dataclasses
from typing import Dict


@dataclasses.dataclass
class Job:
    """A cell's set-up: the inputs the benchmark made from the seed (which
    the reference reads) and the program's objects (freed before the
    check)."""
    inputs: Dict
    program: Dict
