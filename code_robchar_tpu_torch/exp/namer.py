"""Experiment identity = directory/filename convention (a copy of
code_robchar_tpu/exp/namer.py).

Reproduces the reference's path contract (noise_analysis.py:33-49): every
experiment's controller store lives at

    {global_dir}/{experiment_name}/ppo_spin_{N}_{in}-{out}_c_{C}

(the literal "ppo_" prefix is historical and applies to all algorithms —
shipped data depends on it, so it is kept).  Unlike the reference's
ExperimentNamer (whose ``home()`` method replaces itself with a string on
first call, SURVEY.md quirk 3), this one is a frozen dataclass with pure
accessors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class ExperimentNamer:
    experiment_name: str = "alpha"
    Nspin: int = 5
    inspin: int = 0
    outspin: int = 2
    numcontrollers: int = 100
    global_dir: str = "experiments"

    @property
    def home(self) -> str:
        return os.path.join(self.global_dir, self.experiment_name)

    def ensure_home(self) -> str:
        os.makedirs(self.home, exist_ok=True)
        return self.home

    def controller_store(self) -> str:
        return (f"{self.home}/ppo_spin_{self.Nspin}_"
                f"{self.inspin}-{self.outspin}_c_{self.numcontrollers}")

    def __call__(self) -> str:
        """Reference-compatible call form: creates the home directory as a
        side effect (noise_analysis.py:42-46) and returns the store path."""
        self.ensure_home()
        return self.controller_store()
