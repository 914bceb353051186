"""The optimizer zoo and the PPO trainer (counterpart of
code_robchar_tpu/models): batched L-BFGS and Nelder-Mead restarts and PPO
over many agents so far; Adam and SNOB follow in a later slice
(ROADMAP.md)."""

from code_robchar_tpu_torch.models.lbfgs import LBFGS
from code_robchar_tpu_torch.models.nmplus import NMPlus
from code_robchar_tpu_torch.models.ppo import PPO_en

__all__ = ["LBFGS", "NMPlus", "PPO_en"]
