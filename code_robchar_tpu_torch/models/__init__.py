"""The optimizer zoo and the PPO trainer (counterpart of
code_robchar_tpu/models): batched L-BFGS, Nelder-Mead, Adam and SNOB
searches and PPO over many agents.

The registry mirrors the reference's model database
(noise_analysis.py:126-131): {"ppo", "lbfgs", "snob", "adam", "nmplus"}.
The exact-SNOBFIT adapter of the JAX package (``SNOBSkquant``, outside the
registry) is not ported yet (ROADMAP.md)."""

from code_robchar_tpu_torch.models.lbfgs import LBFGS
from code_robchar_tpu_torch.models.adam import Adam
from code_robchar_tpu_torch.models.nmplus import NMPlus
from code_robchar_tpu_torch.models.snob import SNOB
from code_robchar_tpu_torch.models.ppo import PPO_en

MODEL_REGISTRY = {
    "ppo": PPO_en,
    "lbfgs": LBFGS,
    "snob": SNOB,
    "adam": Adam,
    "nmplus": NMPlus,
}

__all__ = ["LBFGS", "Adam", "NMPlus", "SNOB", "PPO_en", "MODEL_REGISTRY"]
