"""The optimizer zoo (counterpart of code_robchar_tpu/models): batched
L-BFGS and Nelder-Mead restarts so far; Adam, SNOB and PPO follow in later
slices (ROADMAP.md)."""

from code_robchar_tpu_torch.models.lbfgs import LBFGS
from code_robchar_tpu_torch.models.nmplus import NMPlus

__all__ = ["LBFGS", "NMPlus"]
