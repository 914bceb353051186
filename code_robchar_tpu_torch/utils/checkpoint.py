"""Training-state checkpointing (torch.save) + the JSON respawn story
(counterpart of code_robchar_tpu/utils/checkpoint.py).

The reference's checkpoint/resume is three JSON mechanisms (SURVEY.md §5):
experiment-cell respawn, fcall-checkpointed controller sets, and
filename-keyed analysis caches — all reproduced in exp/ and mc/.  This
module adds what the reference lacks: durable *training-state* checkpoints
(PPO agent states, optimizer stream states), so long controller searches
survive preemption.

``torch.save`` takes the JAX package's orbax: a state's tensors go to the
host to be saved, and come back onto the template's devices when a
template is given.  A state is a tensor, or a dict, list, tuple or
NamedTuple of states; other leaves are saved as they are.  The ``.pkl``
branch of the JAX package stays: ``restore_state`` looks for
``path + ".pkl"`` first and returns its pickle of host arrays as it is, so
a pickled checkpoint written by the JAX package loads here too.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional

import torch


def _map(fn: Callable[[torch.Tensor, Any], torch.Tensor], state: Any,
         template: Any = None) -> Any:
    """``state`` with every tensor t replaced by fn(t, the template's leaf
    at the same place, or None)."""
    if isinstance(state, torch.Tensor):
        return fn(state, template)
    if isinstance(state, dict):
        return {k: _map(fn, v, None if template is None else template[k])
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        leaves = template if template is not None else [None] * len(state)
        out = [_map(fn, v, t) for v, t in zip(state, leaves)]
        if isinstance(state, list):
            return out
        return type(state)(*out) if hasattr(state, "_fields") else \
            type(state)(out)
    return state


def save_state(path: str, state: Any) -> str:
    """Save a state checkpoint with its tensors on the host."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_map(lambda t, _: t.detach().cpu(), state), path)
    return path


def restore_state(path: str, template: Optional[Any] = None) -> Any:
    """Restore a checkpoint saved by save_state (or a ``.pkl`` pickle of
    the JAX package's), its tensors on the devices of ``template``'s
    tensors when a template is given, else on the host."""
    path = os.path.abspath(path)
    if os.path.exists(path + ".pkl"):
        with open(path + ".pkl", "rb") as f:
            return pickle.load(f)
    state = torch.load(path, map_location="cpu", weights_only=False)
    if template is None:
        return state
    return _map(lambda t, like: t if not isinstance(like, torch.Tensor)
                else t.to(like.device), state, template)
