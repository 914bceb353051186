"""Batched actor-critic for PPO controller search (counterpart of
code_robchar_tpu/models/actor_critic.py).

The same architecture contract: tanh MLPs with (100, 100) hidden units for
both heads, a Gaussian policy with a state-independent learned log-std that
starts at -0.5, the log-probability summed over the action axis, the value
head squeezed to a scalar.

The JAX package vmaps one flax module over agents.  Here the agent axis is
written out: every parameter carries a leading axis A, each Dense layer is
one ``torch.baddbmm`` over the agents, and the parameters are a flat dict
keyed by their flax path without the ``params/`` and ``MLP_0/`` levels:

    pi/Dense_{0,1,2}/{kernel,bias}, pi/log_std, v/Dense_{0,1,2}/{kernel,bias}

with kernels (A, d_in, d_out), biases (A, d_out) and log_std (A, act_dim).
``ActorCritic`` holds such a dict as an ``nn.Module``; the functions below
take the dict itself, which is what the optimizer and the kernels use.

Initialisation follows flax's defaults: Dense kernels ``lecun_normal`` (a
normal truncated to [-2, 2], scaled by sqrt(1/fan_in) / 0.87962566), biases
zero, log_std -0.5.  The draws come from the port's threefry keys
(``jax.random.truncated_normal``'s construction), one key per layer split
from the agent's key.  They are NOT flax's numbers: flax derives each
layer's key from a hash of its module path.  ``params_from_jax`` carries a
flax tree in where the same numbers are needed.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from code_robchar_tpu_torch.ops import prng

HEADS = ("pi", "v")
LAYERS = ("Dense_0", "Dense_1", "Dense_2")
#: stddev of the unit normal truncated to [-2, 2] (flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978
_LOG_2PI = math.log(2 * math.pi)


def _truncated_normal(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``jax.random.truncated_normal(key, -2, 2, shape)``: key (..., 2) ->
    (..., *shape)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lo = math.erf(-2 / math.sqrt(2))
    hi = math.erf(2 / math.sqrt(2))
    u = prng.uniform(key, shape, dtype, lo, hi)
    z = float(npdt(np.sqrt(2))) * prng._erfinv(u)
    return torch.clamp(z, float(np.nextafter(npdt(-2), npdt(0))),
                       float(np.nextafter(npdt(2), npdt(0))))


def init_params(keys: torch.Tensor, obs_dim: int, act_dim: int,
                hidden: Sequence[int] = (100, 100),
                dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """Fresh parameters for A agents from their keys (A, 2)."""
    sizes = {"pi": (*hidden, act_dim), "v": (*hidden, 1)}
    layer_keys = prng.split(keys, 2 * len(LAYERS))          # (A, 6, 2)
    params = {}
    for hi_, head in enumerate(HEADS):
        d_in = obs_dim
        for li, (layer, d_out) in enumerate(zip(LAYERS, sizes[head])):
            k = layer_keys[:, hi_ * len(LAYERS) + li]
            scale = math.sqrt(1.0 / d_in) / _TRUNC_STD
            w = _truncated_normal(k, (d_in, d_out), dtype) * scale
            params[f"{head}/{layer}/kernel"] = w.to(device)
            params[f"{head}/{layer}/bias"] = torch.zeros(
                (keys.shape[0], d_out), dtype=dtype, device=device)
            d_in = d_out
    params["pi/log_std"] = torch.full((keys.shape[0], act_dim), -0.5,
                                      dtype=dtype, device=device)
    return params


def _mlp(params, head: str, obs: torch.Tensor) -> torch.Tensor:
    """The head's MLP on obs (A, T, d_in) -> (A, T, d_out)."""
    x = obs
    for i, layer in enumerate(LAYERS):
        w = params[f"{head}/{layer}/kernel"]
        b = params[f"{head}/{layer}/bias"]
        x = torch.baddbmm(b[:, None, :], x, w)
        if i < len(LAYERS) - 1:
            x = torch.tanh(x)
    return x


def actor(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu (A, T, act_dim), log_std (A, act_dim)) for obs (A, T, d)."""
    return _mlp(params, "pi", obs), params["pi/log_std"]


def critic(params, obs: torch.Tensor) -> torch.Tensor:
    """v (A, T) for obs (A, T, d)."""
    return _mlp(params, "v", obs)[..., 0]


def apply(params, obs: torch.Tensor):
    """(mu, log_std, v), as ``ActorCritic.__call__`` of the JAX package."""
    mu, log_std = actor(params, obs)
    return mu, log_std, critic(params, obs)


def gaussian_logp(mu: torch.Tensor, log_std: torch.Tensor,
                  act: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density summed over the last axis; log_std
    broadcasts against mu."""
    std = torch.exp(log_std)
    z = (act - mu) / std
    return (-0.5 * z ** 2 - log_std - 0.5 * _LOG_2PI).sum(-1)


def policy_step(params, obs: torch.Tensor, key: torch.Tensor):
    """Sample (action, value, logp) without gradients: obs (A, T, d), one
    key for the whole draw."""
    with torch.no_grad():
        mu, log_std, v = apply(params, obs)
        eps = prng.normal(key, tuple(mu.shape), mu.dtype).to(mu.device)
        a = mu + torch.exp(log_std)[:, None, :] * eps
        return a, v, gaussian_logp(mu, log_std[:, None, :], a)


def count_vars(params) -> int:
    """Parameters per agent."""
    return sum(p[0].numel() for p in params.values())


class ActorCritic(nn.Module):
    """The batched parameters of A agents as an ``nn.Module``; calling it
    is ``apply`` on obs (A, T, d)."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = list(params)
        self.params = nn.ParameterList(nn.Parameter(params[k])
                                       for k in self.names)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))

    def forward(self, obs: torch.Tensor):
        return apply(self.as_dict(), obs)


# ------------------------------------------------------- carry from/to JAX

def params_from_jax(tree, dtype: torch.dtype = torch.float64,
                    device=None) -> Dict[str, torch.Tensor]:
    """A batched flax ActorCritic param tree (numpy or jax arrays, leading
    agent axis) as the port's parameter dict."""
    p = tree["params"]
    out = {}
    for head in HEADS:
        mlp = p[head]["MLP_0"]
        for layer in LAYERS:
            for leaf in ("kernel", "bias"):
                out[f"{head}/{layer}/{leaf}"] = torch.as_tensor(
                    np.array(mlp[layer][leaf]), dtype=dtype, device=device)
    out["pi/log_std"] = torch.as_tensor(np.array(p["pi"]["log_std"]),
                                        dtype=dtype, device=device)
    return out


def params_to_jax(params) -> Dict:
    """The port's parameter dict as a flax param tree of numpy arrays."""
    tree = {head: {"MLP_0": {layer: {} for layer in LAYERS}}
            for head in HEADS}
    for name, x in params.items():
        parts = name.split("/")
        arr = x.detach().cpu().numpy()
        if parts[1] == "log_std":
            tree["pi"]["log_std"] = arr
        else:
            tree[parts[0]]["MLP_0"][parts[1]][parts[2]] = arr
    return {"params": tree}
