"""Experiment orchestration: naming, drivers, checkpoint/respawn, CLI
(counterpart of code_robchar_tpu/exp)."""

from code_robchar_tpu_torch.exp.namer import ExperimentNamer
from code_robchar_tpu_torch.exp.experiment import Experiment

__all__ = ["ExperimentNamer", "Experiment"]
