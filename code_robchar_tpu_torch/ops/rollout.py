"""The whole-trajectory PPO rollout: actor MLP + env transition + physics
for T steps of every agent (counterpart of
code_robchar_tpu/ops/pallas_rollout.py).

Each step, per agent:

    obs -> actor MLP (d -> h -> h -> d, tanh) -> a = mu + exp(log_std) eps
    -> vector-wide action wrap and time modulus (models/env.py semantics)
    -> H = h0 + diag(action [+ zdiag]) [+ nearest-neighbour noise]
    -> symmetric Jacobi transfer fidelity -> done / timeout / reset

``actor_env_rollout`` sends CPU tensors to the plain version
(``actor_env_rollout_plain``, a Python loop over T whose steps are
vectorised over agents) and CUDA float32 tensors to the hand-written kernel
``csrc/actor_env_rollout.cu`` (at the PPO path's width ``REG_HIDDEN`` its
register-resident kernel, at other widths its generic one); CUDA float64
raises ``ValueError``.  There is no fallback.  ``build.LAUNCHES`` counts
the two kernels' launches under their C entries' names,
``actor_env_rollout_reg`` and ``actor_env_rollout``.

Layout (the port's own; no sublane padding): the actor's three Dense layers
folded with their bias as the last input row, agent-major,
w1 (A, d+1, h), w2 (A, h+1, h), w3 (A, h+1, d), log_std (A, d); the carry
action (n, A), t (A,), ep_len (A,) int32; the noise streams and the
trajectory with the agents last, as the Pallas kernel's: eps (T, d, A),
zdiag (T, n, A), znn (T, n-1, A) -> a (T, d, A), fid (T, A),
obs2 (T, d, A), done (T, A), timeout (T, A) bool.  The noise is drawn
outside (models/ppo.py): the kernel has no generator.

The pre-step obs is not returned: obs_t = where(terminal_{t-1}, 0,
obs2_{t-1}), with obs_0 the incoming carry.  ``order="roundrobin"`` (the
kernel's Jacobi schedule) is the plain version's default; ``"cyclic"`` is
the XLA scan's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from code_robchar_tpu_torch.ops import cuda_jacobi, realform
from code_robchar_tpu_torch.utils import build

#: the hidden width that takes ``actor_env_rollout_reg_kernel`` (each
#: thread's column of W2 in registers; ``kRegHidden`` in
#: csrc/actor_env_rollout.cu: the PPO path's (100, 100) actor); every
#: other width takes the generic ``actor_env_rollout_kernel`` (W2 in shared
#: memory)
REG_HIDDEN = 100


def smem_bytes(n: int, hid: int) -> int:
    """Shared memory of one block of the kernel that width ``hid`` takes,
    float32: at ``REG_HIDDEN`` h1, W1, the four warps' partial sums of
    layer 3 (16 slots each) and h0; at other widths the three folded
    weights, two hidden activations, the carry and h0."""
    d = n + 1
    if hid == REG_HIDDEN:
        return 4 * (hid + (d + 1) * hid + 4 * 16 + n * n)
    dynamic = (d + 1) * hid + (hid + 1) * hid + (hid + 1) * d + 2 * hid
    return 4 * (dynamic + 3 * d + n * n)


class RolloutOut(NamedTuple):
    a: torch.Tensor            # (T, d, A) sampled actions
    fid: torch.Tensor          # (T, A) reward fidelities
    obs2: torch.Tensor         # (T, d, A) post-step obs (action, time)
    done: torch.Tensor         # (T, A) bool
    timeout: torch.Tensor      # (T, A) bool
    next_action: torch.Tensor  # (n, A) carry after the last step
    next_t: torch.Tensor       # (A,)
    next_ep: torch.Tensor      # (A,) int32


def fold_actor_weights(params):
    """(w1, w2, w3, log_std) in the rollout layout from the batched
    parameter dict of models/actor_critic.py: each Dense kernel (A, i, o)
    with its bias appended as input row i, contiguous."""
    def fold(layer):
        w = params[f"pi/{layer}/kernel"]
        b = params[f"pi/{layer}/bias"]
        return torch.cat([w, b[:, None, :]], dim=1).contiguous()

    return (fold("Dense_0"), fold("Dense_1"), fold("Dense_2"),
            params["pi/log_std"].contiguous())


def wrap_action(a: torch.Tensor, bmax: float) -> torch.Tensor:
    """The action wrap of models/env.py (RLreinforceXXchain_actionedtime.py
    :253-257): when any entry of an action vector (the trailing axis)
    exceeds bmax in magnitude, the whole vector becomes
    ``a % (sign(a) * bmax)`` (1 in place of the divisor at a zero entry),
    ``%`` being the floor remainder whose sign follows the divisor, as
    jnp's."""
    over = (a.abs() > bmax).any(-1, keepdim=True)
    den = torch.sign(a) * bmax + torch.where(a == 0, 1.0, 0.0).to(a.dtype)
    return torch.where(over, torch.remainder(a, den), a)


def normalise_time(t: torch.Tensor, maxtime: float) -> torch.Tensor:
    """|t|, taken modulo maxtime when above it (models/env.py)."""
    t = t.abs()
    return torch.where(t > maxtime, torch.remainder(t, maxtime), t)


def hamiltonian_lanes(h0: torch.Tensor, action: torch.Tensor,
                      zdiag: Optional[torch.Tensor] = None,
                      znn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's Hamiltonians as lanes (n, n, A): h0 (n, n) plus
    diag(action [+ zdiag]) plus znn on both first off-diagonals; action and
    zdiag (n, A), znn (n-1, A)."""
    n, a_cnt = h0.shape[0], action.shape[-1]
    idx = torch.arange(n, device=h0.device)
    ham = h0[:, :, None].expand(n, n, a_cnt).clone()
    add = action if zdiag is None else action + zdiag
    if znn is not None:
        ham[idx[1:], idx[:-1]] += znn
        ham[idx[:-1], idx[1:]] += znn
    ham[idx, idx] += add
    return ham


def rollout_loop(policy, reward, action, tstep, ep_len, eps, *,
                 bmax: float, maxtime: float, max_ep_len: int):
    """The rollout as a Python loop over T, each step vectorised over the
    agents (agent-major): ``policy(obs (A, d)) -> (mu, std)`` (A, d) each,
    a = mu + std * eps[s], the wrap and time modulus, ``reward(s,
    new_action (A, n), t (A,)) -> (A,)``, then done, timeout and reset.
    action (A, n), tstep (A,), ep_len (A,), eps (T, A, d).  Returns the
    carry (action, tstep, ep_len) after the last step and the trajectory
    (obs, a, fid, obs2, done, timeout), each stacked (T, A, ...)."""
    n = action.shape[1]
    outs = []
    for s in range(eps.shape[0]):
        obs = torch.cat([action, tstep[:, None]], dim=1)
        mu, std = policy(obs)
        a = mu + std * eps[s]
        new_action = wrap_action(action + a[:, :n], bmax)
        raw_t = tstep + a[:, n]
        # final_time is the accumulated time (ppo.py:359-361 of the JAX
        # package): done fires when the modulus shrinks the time below it
        t = normalise_time(raw_t, maxtime)
        done = t > raw_t
        fid = reward(s, new_action, t)
        ep_len = ep_len + 1
        timeout = ep_len == max_ep_len
        term = done | timeout
        outs.append((obs, a, fid, torch.cat([new_action, t[:, None]], dim=1),
                     done, timeout))
        action = torch.where(term[:, None], 0.0, new_action)
        tstep = torch.where(term, 0.0, t)
        ep_len = torch.where(term, 0, ep_len)
    return (action, tstep, ep_len), tuple(torch.stack(x) for x in zip(*outs))


def actor_env_rollout_plain(w1, w2, w3, log_std, h0, action, tstep, ep_len,
                            eps, zdiag, znn, *, in_spin: int, out_spin: int,
                            sweeps: int, bmax: float, maxtime: float,
                            max_ep_len: int, ham_noisy: bool,
                            order: str = "roundrobin") -> RolloutOut:
    """The rollout as torch ops, one step at a time (shapes in the module
    docstring; zdiag and znn are read only when ``ham_noisy``)."""
    d = h0.shape[0] + 1
    std = torch.exp(log_std)                          # (A, d)

    def policy(obs):
        x = torch.tanh(torch.baddbmm(w1[:, d:], obs[:, None], w1[:, :d]))
        x = torch.tanh(torch.baddbmm(w2[:, -1:], x, w2[:, :-1]))
        return torch.baddbmm(w3[:, -1:], x, w3[:, :-1])[:, 0], std

    def reward(s, new_action, t):
        ham = hamiltonian_lanes(h0, new_action.T,
                                zdiag[s] if ham_noisy else None,
                                znn[s] if ham_noisy else None)
        phr, phi = realform.transfer_amp_sym_lanes(ham, t, in_spin, out_spin,
                                                   sweeps, order=order)
        return phr * phr + phi * phi

    (act, t, ep), (_, a, fid, obs2, done, timeout) = rollout_loop(
        policy, reward, action.T, tstep, ep_len, eps.permute(0, 2, 1),
        bmax=bmax, maxtime=maxtime, max_ep_len=max_ep_len)
    return RolloutOut(a=a.permute(0, 2, 1).contiguous(), fid=fid,
                      obs2=obs2.permute(0, 2, 1).contiguous(), done=done,
                      timeout=timeout, next_action=act.T.contiguous(),
                      next_t=t, next_ep=ep.to(torch.int32))


# 19 pointers; n, h, in_spin, out_spin, sweeps; eps, bmax, maxtime;
# max_ep_len, ham_noisy, T, A
_ARGS = (build.P,) * 19 + (build.I,) * 5 + (build.F,) * 3 + (build.I,) * 4
_ENTRIES = {True: build.kernel("actor_env_rollout_reg", *_ARGS),
            False: build.kernel("actor_env_rollout", *_ARGS)}


def actor_env_rollout_cuda(w1, w2, w3, log_std, h0, action, tstep, ep_len,
                           eps, zdiag, znn, *, in_spin: int, out_spin: int,
                           sweeps: int, bmax: float, maxtime: float,
                           max_ep_len: int, ham_noisy: bool) -> RolloutOut:
    """Launch the kernel of width ``w2.shape[-1]`` on the current stream
    (not synchronised): float32 tensors on one CUDA device, ep_len int32,
    shapes in the module docstring."""
    tensors = dict(w1=w1, w2=w2, w3=w3, log_std=log_std, h0=h0,
                   action=action, tstep=tstep, eps=eps, ep_len=ep_len)
    if ham_noisy:
        tensors.update(zdiag=zdiag, znn=znn)
    build.check_device(**tensors)
    build.check_layout({"ep_len": torch.int32}, **tensors)
    n, (t_len, d, a_cnt) = h0.shape[0], eps.shape
    hid = w2.shape[-1]
    shapes = dict(w1=(a_cnt, d + 1, hid), w2=(a_cnt, hid + 1, hid),
                  w3=(a_cnt, hid + 1, d), log_std=(a_cnt, d), h0=(n, n),
                  action=(n, a_cnt), tstep=(a_cnt,), ep_len=(a_cnt,),
                  eps=(t_len, n + 1, a_cnt), zdiag=(t_len, n, a_cnt),
                  znn=(t_len, n - 1, a_cnt))
    for name, want in shapes.items():
        x = tensors.get(name)
        if x is not None and tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(x.shape)}")
    build.check_n(n, in_spin, out_spin)
    if hid < 1 or smem_bytes(n, hid) > build.SMEM_PER_BLOCK:
        raise ValueError(f"hidden width {hid}: the weights do not fit in "
                         f"one block's shared memory "
                         f"({build.SMEM_PER_BLOCK} bytes)")

    dev = h0.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = RolloutOut(
        a=torch.empty((t_len, d, a_cnt), **f32),
        fid=torch.empty((t_len, a_cnt), **f32),
        obs2=torch.empty((t_len, d, a_cnt), **f32),
        done=torch.empty((t_len, a_cnt), dtype=torch.bool, device=dev),
        timeout=torch.empty((t_len, a_cnt), dtype=torch.bool, device=dev),
        next_action=torch.empty((n, a_cnt), **f32),
        next_t=torch.empty((a_cnt,), **f32),
        next_ep=torch.empty((a_cnt,), dtype=torch.int32, device=dev))
    if a_cnt == 0:
        return out
    ptrs = [w1, w2, w3, log_std, h0, action, tstep, ep_len, eps,
            zdiag if ham_noisy else None, znn if ham_noisy else None, *out]
    _ENTRIES[hid == REG_HIDDEN](
        dev, *(None if p is None else p.data_ptr() for p in ptrs),
        n, hid, in_spin, out_spin, sweeps, cuda_jacobi.EPS, float(bmax),
        float(maxtime), int(max_ep_len), int(bool(ham_noisy)), t_len, a_cnt)
    return out


def actor_env_rollout(w1, w2, w3, log_std, h0, action, tstep, ep_len, eps,
                      zdiag: Optional[torch.Tensor],
                      znn: Optional[torch.Tensor], *, in_spin: int,
                      out_spin: int, sweeps: int, bmax: float,
                      maxtime: float, max_ep_len: int,
                      ham_noisy: bool) -> RolloutOut:
    """The whole T-step rollout: CPU tensors take the plain version
    (round-robin Jacobi, as the kernel), CUDA tensors the kernel."""
    kw = dict(in_spin=in_spin, out_spin=out_spin, sweeps=sweeps, bmax=bmax,
              maxtime=maxtime, max_ep_len=max_ep_len, ham_noisy=ham_noisy)
    if h0.device.type == "cpu":
        return actor_env_rollout_plain(w1, w2, w3, log_std, h0, action,
                                       tstep, ep_len, eps, zdiag, znn, **kw)
    return actor_env_rollout_cuda(w1, w2, w3, log_std, h0, action, tstep,
                                  ep_len, eps, zdiag, znn, **kw)
