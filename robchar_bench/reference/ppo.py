"""PPO controller search for many agents in plain NumPy and PyTorch: the
reference of the ``ppo`` cells (the spinningup-derived trainer of the
paper's reference program, one independent search per agent).

An agent: a Gaussian policy mu(obs) + exp(log_std) eps (tanh MLP d -> 100 ->
100 -> d, log_std starting at -0.5) and a value critic (d -> 100 -> 100 ->
1), obs = (biases, time) of the current controller, d = n + 1.  Its
parameters start from flax's defaults (Dense kernels lecun-normal: a unit
normal truncated to [-2, 2] times sqrt(1 / fan_in) / 0.87962566, biases 0),
drawn from threefry keys: key(seed), split into one key an agent, each split
into the parameter key and the carried key, the parameter key split into
one key a layer (pi's three, then v's).

An epoch of T steps, all randomness from agent 0's carried key k:
k_eps, k_ham, _, k_next = split(k, 4); eps (T, A, d) normal from k_eps;
the Hamiltonian noise, diagonal (T, A, n) from k_ham and couplings
(T, A, n - 1) from fold_in(k_ham, 1), each times sigma; the agents' next
keys split(k_next, A).  A step: a = mu(obs) + std eps; the controller's
biases b + a[:n], the whole vector wrapped as b mod (sign(b) bmax) when an
entry exceeds bmax; the time |t + a[n]|, modulo maxtime above it; the
episode ends ("done") when that time is above t + a[n], or on its
max_ep_len-th step ("timeout"), and the next step starts from zeros; the
reward is the transfer fidelity of H0 + diag(b + noise) + coupling noise
at the new time (reference/physics.py; the port's rollout takes 4 Jacobi
sweeps, which part from the exact eigenvalues by under ~1e-6).  Then
GAE-lambda advantages (bootstrapped at ends, 0 where done without
timeout; the epoch's end closes the open episode), normalised per agent;
up to 200 clipped-surrogate Adam steps of the policy, each agent stopping
where its KL from the rollout's policy passes 1.5 target_kl (that round
not applied); 200 Adam steps of the critic on the mean squared error to
the rewards-to-go, full batch.  Adam as optax's (b1 0.9, b2 0.999, eps
1e-8).

A rollout parts from any other computation of it after a few hundred steps:
a rounding that moves a controller across the wrap or the time modulus
sends that agent's trajectory elsewhere, and the update that follows parts
with it.  So the reference judges an epoch from the program's own state
and trajectory, step by step: ``rollout`` takes each step from the
program's pre-step observation and returns what the step gives, and
``update`` takes the program's trajectory and rewards and returns the
parameters the update gives.  ``init_state`` and the key chain
(``epoch_keys``) are the reference's own.

Precision: float64 throughout, except the critic's products, whose
operands are rounded to bfloat16 with float64 sums where the
configuration states bfloat16 operands (``critic="bfloat16"``).  The
control (``precision="tf32"``) rounds every product's operands to TF32
and the critic's to float8 (e4m3), the precisions below the stated ones.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
from scipy import special

from robchar_bench.reference import physics, threefry

HEADS = ("pi", "v")
LAYERS = ("Dense_0", "Dense_1", "Dense_2")
TRUNC_STD = 0.87962566103423978


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, to nearest even),
    in x's dtype; as reference/physics.tf32 on tensors."""
    b = x.detach().to(torch.float32).view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).to(x.dtype)


def _round_fn(precision: str):
    """The rounding of a product's operands: the value rounded, the
    gradient passed through."""
    if precision == "tf32":
        return lambda x: x + (tf32(x) - x).detach()
    return lambda x: x


def _critic_round(critic: str, precision: str):
    kind = {"bfloat16": torch.bfloat16, "float8": torch.float8_e4m3fn}.get(
        "float8" if precision == "tf32" else critic)
    if kind is None:
        return lambda x: x
    return lambda x: x.to(kind).to(x.dtype)


def _adam(count, mu, nu, params, grads, lr, mask=None):
    """optax.adam's step on the leaves of ``grads``; ``mask`` (A,) keeps
    an agent's state where False."""
    count2 = count + 1
    c = count2.to(torch.float64)
    out_p, out_m, out_v = dict(params), dict(mu), dict(nu)
    for k, g in grads.items():
        shape = (-1,) + (1,) * (g.dim() - 1)
        m = 0.1 * g + 0.9 * mu[k]
        v = 0.001 * g * g + 0.999 * nu[k]
        upd = (m / (1 - 0.9 ** c).reshape(shape)) / (
            torch.sqrt(v / (1 - 0.999 ** c).reshape(shape)) + 1e-8)
        p = params[k] - lr * upd
        if mask is not None:
            keep = mask.reshape(shape)
            p = torch.where(keep, p, params[k])
            m = torch.where(keep, m, mu[k])
            v = torch.where(keep, v, nu[k])
        out_p[k], out_m[k], out_v[k] = p, m, v
    if mask is not None:
        count2 = torch.where(mask, count2, count)
    return count2, out_m, out_v, out_p


def init_params(seed: int, agents: int, n: int, hidden: int = 100,
                device="cpu"):
    """(params, the agents' carried keys (A, 2)) of fresh agents."""
    d = n + 1
    ks = _agent_keys(seed, agents)
    layer_keys = threefry.split(ks[:, 0], 2 * len(LAYERS))
    lo = np.float32(math.erf(-2 / math.sqrt(2)))
    hi = np.float32(math.erf(2 / math.sqrt(2)))
    edge = float(np.nextafter(np.float32(2), np.float32(0)))
    sizes = {"pi": (hidden, hidden, d), "v": (hidden, hidden, 1)}
    params = {}
    for h_i, head in enumerate(HEADS):
        d_in = d
        for l_i, (layer, d_out) in enumerate(zip(LAYERS, sizes[head])):
            u = threefry.uniform32(layer_keys[:, h_i * len(LAYERS) + l_i],
                                   d_in * d_out, float(lo), float(hi))
            z = np.clip(np.sqrt(2.0) * special.erfinv(u.astype(np.float64)),
                        -edge, edge)
            w = z.reshape(agents, d_in, d_out) * (
                math.sqrt(1.0 / d_in) / TRUNC_STD)
            params[f"{head}/{layer}/kernel"] = torch.as_tensor(w,
                                                               device=device)
            params[f"{head}/{layer}/bias"] = torch.zeros(
                (agents, d_out), dtype=torch.float64, device=device)
            d_in = d_out
    params["pi/log_std"] = torch.full((agents, d), -0.5, dtype=torch.float64,
                                      device=device)
    return params, ks[:, 1]


def _agent_keys(seed: int, agents: int) -> np.ndarray:
    """Each agent's (parameter key, carried key), (A, 2, 2)."""
    key = threefry.key(seed)
    keys = threefry.split(key, agents) if agents > 1 else key[None]
    return threefry.split(keys, 2)


def epoch_keys(seed: int, agents: int, epochs: int):
    """Agent 0's carried key at the start of each of the first ``epochs``
    epochs."""
    keys = _agent_keys(seed, agents)[:, 1]
    out = []
    for _ in range(epochs):
        out.append(keys[0])
        keys = threefry.split(threefry.split(keys[0], 4)[3], agents)
    return out


def draws(key, agents: int, t_len: int, n: int, sigma: float):
    """The epoch's policy noise eps (T, A, n + 1) and Hamiltonian noise
    (T, A, n), (T, A, n - 1) from agent 0's key."""
    d = n + 1
    k_eps, k_ham, _, _ = threefry.split(key, 4)
    eps = threefry.normal(k_eps, t_len * agents * d).reshape(t_len, agents, d)
    sigma = np.float32(sigma).astype(np.float64)
    zdiag = threefry.normal(k_ham, t_len * agents * n).reshape(
        t_len, agents, n) * sigma
    znn = threefry.normal(threefry.fold_in(k_ham, 1),
                          t_len * agents * (n - 1)).reshape(
        t_len, agents, n - 1) * sigma
    return eps, zdiag, znn


def _mlp(params, head, x, rnd):
    for i, layer in enumerate(LAYERS):
        x = torch.baddbmm(params[f"{head}/{layer}/bias"][:, None, :],
                          rnd(x), rnd(params[f"{head}/{layer}/kernel"]))
        if i < len(LAYERS) - 1:
            x = torch.tanh(x)
    return x


def _logp(mu, log_std, act):
    z = (act - mu) / torch.exp(log_std)[:, None, :]
    return (-0.5 * z ** 2 - log_std[:, None, :]
            - 0.5 * math.log(2 * math.pi)).sum(-1)


def _wrap(b, bmax):
    over = (np.abs(b) > bmax).any(-1, keepdims=True)
    den = np.sign(b) * bmax + (b == 0)
    return np.where(over, np.mod(b, den), b)


class Rollout(NamedTuple):
    obs: np.ndarray       # (T, A, d) pre-step observations (the program's)
    act: np.ndarray       # (T, A, d) the step's action from obs
    obs2: np.ndarray      # (T, A, d) the step's new controller from obs
    reward: np.ndarray    # (T, A) the fidelity at the program's obs2
    done: np.ndarray      # (T, A)
    timeout: np.ndarray   # (T, A)


def rollout(params, action, tstep, ep_len, obs2_prog, key, cfg: Dict,
            mix: Dict, device="cpu", precision="float64") -> Rollout:
    """Each step of an epoch from the program's pre-step observation: the
    carry (action (A, n), tstep (A,), ep_len (A,)) at the epoch's start,
    then obs2_prog (T, A, d), reset where this step ends the episode."""
    n, t_len = cfg["n"], mix["steps_per_epoch"]
    a_cnt = action.shape[0]
    bmax = cfg["controller_box"]["bias"][1]
    maxtime = cfg["controller_box"]["time"][1]
    rnd = _round_fn(precision)
    prec = "tf32" if precision == "tf32" else "float64"
    eps, zdiag, znn = draws(key, a_cnt, t_len, n, mix["noise"])
    h0 = physics.xx_chain(n)
    i = np.arange(n)
    with torch.no_grad():
        std = torch.exp(params["pi/log_std"]).cpu().numpy()
    out = {k: [] for k in Rollout._fields}
    for s in range(t_len):
        obs = np.concatenate([action, tstep[:, None]], axis=1)
        with torch.no_grad():
            mu = _mlp(params, "pi", torch.as_tensor(obs[:, None, :],
                                                    device=device), rnd)
        a = mu[:, 0].cpu().numpy() + std * eps[s]
        new_action = _wrap(action + a[:, :n], bmax)
        raw_t = tstep + a[:, n]
        t = np.abs(raw_t)
        t = np.where(t > maxtime, np.mod(t, maxtime), t)
        done = t > raw_t
        prog = obs2_prog[s]
        ham = np.broadcast_to(h0, (a_cnt, n, n)).copy()
        ham[:, i, i] += prog[:, :n] + zdiag[s]
        ham[:, i[1:], i[:-1]] += znn[s]
        ham[:, i[:-1], i[1:]] += znn[s]
        fid = physics.fidelity(ham, prog[:, n], cfg["in_site"],
                               cfg["out_site"], prec)
        ep_len = ep_len + 1
        timeout = ep_len == mix["max_ep_len"]
        term = done | timeout
        for k, v in (("obs", obs), ("act", a), ("reward", fid),
                     ("obs2", np.concatenate([new_action, t[:, None]], 1)),
                     ("done", done), ("timeout", timeout)):
            out[k].append(v)
        action = np.where(term[:, None], 0.0, prog[:, :n])
        tstep = np.where(term, 0.0, prog[:, n])
        ep_len = np.where(term, 0, ep_len)
    return Rollout(**{k: np.stack(v) for k, v in out.items()})


def update(params, pi_opt: Dict, vf_opt: Dict, ro: Rollout, rewards,
           obs2, cfg: Dict, mix: Dict, device="cpu",
           precision: str = "float64", critic: str = "bfloat16"):
    """The epoch's update from its trajectory (``ro``'s observations and
    actions, the program's ``rewards`` (T, A) and new controllers ``obs2``
    (T, A, d)): (params, the first gradient's norm by leaf, pi_iters,
    the optimizers' states after the update: {"pi": ..., "vf": ...}, each
    {"count", "mu", "nu"})."""
    t_len = mix["steps_per_epoch"]
    rnd = _round_fn(precision)
    dev = torch.device(device)

    def agent_major(x):
        return torch.as_tensor(np.swapaxes(x, 0, 1), device=dev)

    obs_af, act_af = agent_major(ro.obs), agent_major(ro.act)
    rew = torch.as_tensor(rewards, device=dev)
    done = torch.as_tensor(ro.done, device=dev)
    timeout = torch.as_tensor(ro.timeout, device=dev)
    a_cnt = obs_af.shape[0]
    with torch.no_grad():
        logp_old = _logp(_mlp(params, "pi", obs_af, rnd),
                         params["pi/log_std"], act_af)
        val = _mlp(params, "v", obs_af, rnd)[..., 0].T
        vboot = _mlp(params, "v", agent_major(obs2), rnd)[..., 0].T
        boot = torch.where(done & ~timeout, 0.0, vboot)
        bounds = done | timeout
        bounds[-1] = True
        gamma, lam = mix["gamma"], mix["lam"]
        advs = torch.empty_like(rew)
        rets = torch.empty_like(rew)
        adv_n = ret_n = v_n = torch.zeros_like(rew[0])
        for s in reversed(range(t_len)):
            b = bounds[s]
            delta = rew[s] + gamma * torch.where(b, boot[s], v_n) - val[s]
            adv_n = delta + gamma * lam * torch.where(b, 0.0, adv_n)
            ret_n = rew[s] + gamma * torch.where(b, boot[s], ret_n)
            advs[s], rets[s], v_n = adv_n, ret_n, val[s]
        advs = (advs - advs.mean(0)) / torch.clamp_min(
            advs.std(0, correction=0), 1e-8)
        advs = advs.T

    # the policy: KL-gated clipped surrogate
    names = [k for k in params if k.startswith("pi/")]
    count, mu_m, nu_m = pi_opt["count"], pi_opt["mu"], pi_opt["nu"]
    iters = mix["train_pi_iters"]
    active = torch.full((a_cnt,), iters > 0, dtype=torch.bool, device=dev)
    pi_iters = torch.zeros(a_cnt, dtype=torch.int64, device=dev)
    first = {}
    for it in range(iters):
        if not bool(active.any()):
            break
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        logp = _logp(_mlp(leaves, "pi", obs_af, rnd), leaves["pi/log_std"],
                     act_af)
        ratio = torch.exp(logp - logp_old)
        clip = mix["clip_ratio"]
        loss = -torch.minimum(ratio * advs, torch.clamp(
            ratio, 1 - clip, 1 + clip) * advs).mean(1)
        kl = (logp_old - logp).mean(1).detach()
        grads = dict(zip(names, torch.autograd.grad(loss.sum(),
                                                    list(leaves.values()))))
        if it == 0:
            first.update({k: float(g.norm()) for k, g in grads.items()})
        ok = active & (kl <= 1.5 * mix["target_kl"])
        count, mu_m, nu_m, params = _adam(count, mu_m, nu_m, params, grads,
                                          mix["pi_lr"], mask=ok)
        params = {k: v.detach() for k, v in params.items()}
        pi_iters = pi_iters + ok.long()
        active = ok & (pi_iters < iters)

    states = {"pi": {"count": count, "mu": mu_m, "nu": nu_m}}

    # the critic: full-batch Adam on the squared error to the returns, the
    # backward written out so that each product's operands are rounded
    # as the configuration states
    crd = _critic_round(critic, precision)
    count, mu_m, nu_m = vf_opt["count"], vf_opt["mu"], vf_opt["nu"]
    ret = rets.T[..., None]
    ones = torch.ones_like(obs_af[..., :1])
    xr = crd(torch.cat([obs_af, ones], 2))
    hid = params["v/Dense_1/kernel"].shape[-1]
    for it in range(mix["train_v_iters"]):
        w1, w2, w3 = (crd(torch.cat([params[f"v/{layer}/kernel"],
                                     params[f"v/{layer}/bias"][:, None, :]],
                                    1)) for layer in LAYERS)
        h1 = torch.tanh(torch.bmm(xr, w1))
        h1a = crd(torch.cat([h1, ones], 2))
        h2 = torch.tanh(torch.bmm(h1a, w2))
        h2a = crd(torch.cat([h2, ones], 2))
        dv = crd((2.0 / t_len) * (torch.bmm(h2a, w3) - ret))
        g3 = torch.bmm(h2a.transpose(1, 2), dv)
        dz2 = crd(dv * w3[:, None, :hid, 0] * (1.0 - h2 * h2))
        g2 = torch.bmm(h1a.transpose(1, 2), dz2)
        dz1 = crd(torch.bmm(dz2, w2[:, :hid].transpose(1, 2))
                  * (1.0 - h1 * h1))
        g1 = torch.bmm(xr.transpose(1, 2), dz1)
        grads = {}
        for layer, g in zip(LAYERS, (g1, g2, g3)):
            grads[f"v/{layer}/kernel"] = g[:, :-1]
            grads[f"v/{layer}/bias"] = g[:, -1]
        if it == 0:
            first.update({k: float(g.norm()) for k, g in grads.items()})
        count, mu_m, nu_m, params = _adam(count, mu_m, nu_m, params, grads,
                                          mix["vf_lr"])
    states["vf"] = {"count": count, "mu": mu_m, "nu": nu_m}
    return params, first, pi_iters.cpu().numpy(), states


def fresh_opt(params, head: str) -> Dict:
    """optax.adam's initial state for the leaves of ``head`` ("pi" or
    "v"): count 0 an agent, zero moments."""
    leaves = {k: torch.zeros_like(v) for k, v in params.items()
              if k.startswith(head + "/")}
    a_cnt = next(iter(leaves.values())).shape[0]
    return {"count": torch.zeros(a_cnt, dtype=torch.int64,
                                 device=next(iter(leaves.values())).device),
            "mu": leaves, "nu": dict(leaves)}
