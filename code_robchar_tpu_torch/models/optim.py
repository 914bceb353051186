"""Adam over batched parameter dicts, with a per-agent mask (the
counterpart of ``optax.adam`` as models/ppo.py of the JAX package uses it),
and RMSprop on one tensor (``optax.rmsprop``, as ``ngd`` of
models/base.py of the JAX package uses it).

Each agent owns its parameters and its optimizer state: every tensor carries
the leading agent axis A, and ``count`` is (A,).  ``adam_update`` follows
optax's order of operations, so that at float64 it lands on optax's numbers:

    mu  = (1 - b1) * g + b1 * mu
    nu  = (1 - b2) * g**2 + b2 * nu
    count += 1
    update = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
    p = p + (-lr) * update

``torch.optim.Adam`` is not used: it rounds in another order, and it cannot
leave some agents untouched.  ``mask`` (A,) bool does that: an agent where
it is False keeps its parameters, moments and count (the PPO KL gate).
Only the leaves named in ``grads`` move.  A leaf left out would see zero
gradients, and from zero moments that changes nothing (its update is
0 / (0 + eps)), so leaving it out is exact: the pi loss has no gradient on
the value head and the value loss none on the policy.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamState(NamedTuple):
    count: torch.Tensor                 # (A,) int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    a = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    return AdamState(count=torch.zeros(a, dtype=torch.int32, device=dev),
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def _per_agent(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(A,) -> broadcastable against ``like`` (A, ...)."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def adam_update(grads: Dict[str, torch.Tensor], state: AdamState,
                params: Dict[str, torch.Tensor], lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                mask: Optional[torch.Tensor] = None):
    """One Adam step on the leaves in ``grads``; returns (params, state),
    new dicts holding every leaf of the inputs.  Gradients are detached."""
    count = state.count + 1
    # 1 - decay**count in float64, then rounded to the leaves' dtype, as
    # optax computes it under x64
    c64 = count.to(torch.float64)
    bc1 = 1.0 - b1 ** c64
    bc2 = 1.0 - b2 ** c64
    new_p, new_mu, new_nu = dict(params), dict(state.mu), dict(state.nu)
    for k, g in grads.items():
        g = g.detach()
        p = params[k]
        mu = (1 - b1) * g + b1 * state.mu[k]
        nu = (1 - b2) * g ** 2 + b2 * state.nu[k]
        m_hat = mu / _per_agent(bc1.to(p.dtype), p)
        v_hat = nu / _per_agent(bc2.to(p.dtype), p)
        p2 = p.detach() + (m_hat / (torch.sqrt(v_hat) + eps)) * (-lr)
        if mask is not None:
            keep = _per_agent(mask, p)
            p2 = torch.where(keep, p2, p.detach())
            mu = torch.where(keep, mu, state.mu[k])
            nu = torch.where(keep, nu, state.nu[k])
        new_p[k], new_mu[k], new_nu[k] = p2, mu, nu
    if mask is not None:
        count = torch.where(mask, count, state.count)
    return new_p, AdamState(count=count, mu=new_mu, nu=new_nu)


def rmsprop_update(grad: torch.Tensor, nu: torch.Tensor, w: torch.Tensor,
                   lr: float, decay: float = 0.9, eps: float = 1e-8):
    """One step of ``optax.rmsprop(lr)`` at its defaults (``scale_by_rms``
    with ``eps_in_sqrt=True``, no bias correction, no momentum, the
    accumulator starting at 0); returns (w, nu):

        nu = (1 - decay) * g**2 + decay * nu
        w  = w + (rsqrt(nu + eps) * g) * (-lr)
    """
    nu = (1 - decay) * grad ** 2 + decay * nu
    return w + (torch.rsqrt(nu + eps) * grad) * (-lr), nu
