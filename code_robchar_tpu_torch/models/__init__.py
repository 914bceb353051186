"""The optimizer zoo and the PPO trainer (counterpart of
code_robchar_tpu/models): batched L-BFGS, Nelder-Mead, Adam and SNOB
searches and PPO over many agents.

The registry mirrors the reference's model database
(noise_analysis.py:126-131): {"ppo", "lbfgs", "snob", "adam", "nmplus"}.
The exact-SNOBFIT adapter ``SNOBSkquant`` (models/snob_skquant.py, on the
vendored engine of models/snobfit_core.py) stays outside the registry, as
in the JAX package."""

from code_robchar_tpu_torch.models.lbfgs import LBFGS
from code_robchar_tpu_torch.models.adam import Adam
from code_robchar_tpu_torch.models.nmplus import NMPlus
from code_robchar_tpu_torch.models.snob import SNOB
from code_robchar_tpu_torch.models.ppo import PPO_en
# exact-SNOBFIT adapter: importing it needs no skquant (the engine is
# resolved at construction); not in the registry, whose five names are the
# reference's (noise_analysis.py:126-131)
from code_robchar_tpu_torch.models.snob_skquant import SNOBSkquant

MODEL_REGISTRY = {
    "ppo": PPO_en,
    "lbfgs": LBFGS,
    "snob": SNOB,
    "adam": Adam,
    "nmplus": NMPlus,
}

__all__ = ["LBFGS", "Adam", "NMPlus", "SNOB", "PPO_en", "SNOBSkquant",
           "MODEL_REGISTRY"]
