"""Cache filename conventions and JSON IO (a copy of
code_robchar_tpu/utils/io.py: framework-free host code, which the port
cannot import from the JAX package, since importing any of it pulls in
jax).

The reference's on-disk artifacts are JSON files whose *names* are the cache
keys (SURVEY.md §2.2).  For interchangeability we reproduce the convention
byte-for-byte, including its quirk of embedding ``str(numpy_array)`` for the
noise grid (mcsim.py:351-356):

    {controller_store}_tn{training_noise}_br_{bootreps}_nlvl{noises}.mc
    ...mcm  (metric tensors), ...tsne (embeddings)

where ``{controller_store}`` is the ExperimentNamer path
``experiments/{exp}/ppo_spin_{N}_{in}-{out}_c_{C}`` (noise_analysis.py:48-49)
plus optional suffixes (.le / .le_nsh / .le_sh).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def noises_tag(noises: np.ndarray) -> str:
    """The literal str(np.ndarray) the reference embeds in cache names."""
    return str(np.asarray(noises))


def mc_cache_name(controller_store: str, training_noise, bootreps: int,
                  noises: np.ndarray) -> str:
    """.mc cache path for a fidelity-distribution tensor (mcsim.py:351-356).

    ``training_noise`` is formatted with plain str() — the reference passes
    either None (lbfgs), a float, or a string key, and all three spellings
    appear in shipped cache names.
    """
    return "{}_tn{}_br_{}_nlvl{}.mc".format(
        controller_store, training_noise, bootreps, noises_tag(noises))


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def dump_json(obj: Any, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)  # atomic: a crashed writer never corrupts a cache
