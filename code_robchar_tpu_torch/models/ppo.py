"""PPO controller synthesis for many agents at once (counterpart of
code_robchar_tpu/models/ppo.py).

Reference: ppo.py (spinningup-derived torch trainer driving the numpy env
step by step, SURVEY.md §3.2).  One *epoch* — a T-step rollout,
GAE-lambda, KL-early-stopped clipped-surrogate policy updates, value
regression — runs for all ``num_agents`` independent controller searches
together, each agent with its own actor-critic and optimizer state (the
agent axis written out where the JAX package vmaps):

1. the rollout: the whole-trajectory kernel ``csrc/actor_env_rollout.cu``
   (ops/rollout.py) when the regime allows it, else a per-step loop whose
   reward is the amplitude kernel ``csrc/sym_jacobi_amp.cu``
   (ops/cuda_jacobi.transfer_amp_sym), which also serves the fixed-ham
   ensemble reward and carries the shot noise on the reward
   (``fid_noisy``: ops/noise.py, the adaptive protocol billing its shots);
2. values and log-probabilities in one batched forward, true fidelities in
   one amplitude-kernel batch, bootstrap values, GAE and the advantage
   normalisation;
3. the KL-gated policy loop: ``torch.bmm`` through autograd and the
   masked Adam of models/optim.py (the JAX package leaves it to XLA);
4. the critic: ``train_v_iters`` Adam steps in one launch of
   ``csrc/critic_train_bf16.cu`` (ops/critic.py with ``fast_dot=True``:
   bfloat16 operands and float32 sums on the card's tensor cores, as the
   JAX package's ``fast_dot=use_pallas`` on its device; full precision on
   the CPU), or a full-precision autograd loop with optax's Adam when
   ``fused_critic=False``.

On the CPU the kernels' plain versions run in their place.  All of an
epoch's randomness comes from agent 0's key, drawn in batched draws
(policy noise, diagonal and nearest-neighbour Hamiltonian noise, one shot
key per step and agent) with the JAX package's key schedule, so the port
draws the same numbers; the per-agent keys are re-split from the fourth
key.

Hyperparameter contract as the reference's, including its quirk that
run() applies its own defaults for train_pi_iters / train_v_iters /
clip_ratio / lrs and honours only the constructor's lam / gamma
(ppo.py:216-231).  One env step bills 1 function call (x train_size under
fixed-ham, ppo.py:364-371), or ``extra + draws`` under the adaptive
shot protocol.

With ``use_wass_value_targets`` the critic regresses onto the negated
Wasserstein robustness cost of each visited (pre-step) controller in place
of the returns (ppo.py:280-283 of the reference program): ham-noisy
fidelities of ``wass_bootstrap_reps`` draws each, keys
``split(fold_in(keys_out[0], 11), T * A)`` from the rollout's refreshed
agent keys, as the JAX package's epoch (ppo.py:681-693), through the
amplitude kernel in chunks (models/objectives.make_wass_cost); the
advantages keep the GAE from the value baseline.

With a ``mesh`` (parallel/mesh.py) and more than one agent, the agent
axis is split over the mesh's entries: ``run()`` lays the state out in
blocks and each block trains its agents through the epoch above on its
entry's device, its randomness from the block's own first agent's key,
as the JAX package's sharded epoch draws it; the epoch's outputs are
gathered on the mesh's first device.

Nothing is compiled, so the JAX package's program cache has no
counterpart: the epoch reads ``env.noise`` at each call.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.models import actor_critic as ac
from code_robchar_tpu_torch.models import objectives, optim
from code_robchar_tpu_torch.models.env import (EnvConfig, EnvState,
                                               Environment)
from code_robchar_tpu_torch.ops import critic as critic_ops
from code_robchar_tpu_torch.ops import cuda_jacobi, noise as noise_ops
from code_robchar_tpu_torch.ops import prng, realform
from code_robchar_tpu_torch.ops import rollout as rollout_ops
from code_robchar_tpu_torch.utils import trace
from code_robchar_tpu_torch.utils.record import RunRecord, TopControllers
from code_robchar_tpu_torch.utils.timeout import Deadline


class AgentState(NamedTuple):
    """Every leaf carries the leading agent axis A."""
    params: Dict[str, torch.Tensor]
    pi_opt: optim.AdamState
    vf_opt: optim.AdamState
    env: EnvState          # action (A, n), timestep (A,), final_time (A,)
    obs: torch.Tensor      # (A, n+1)
    ep_len: torch.Tensor   # (A,) int32
    key: torch.Tensor      # (A, 2)


class EpochOut(NamedTuple):
    rewards: torch.Tensor     # (A, T)
    true_fids: torch.Tensor   # (A, T)
    stores: torch.Tensor      # (A, T, d) controller = (bias..., time)
    fcalls: torch.Tensor      # (A, T)
    kl: torch.Tensor          # (A,)
    pi_iters: torch.Tensor    # (A,)


def gae_and_returns(rewards, values, boundaries, bootstrap, gamma, lam):
    """GAE-lambda advantages and discounted rewards-to-go, (T, A) each,
    with in-trajectory boundaries (PPOBuffer.finish_path semantics,
    ppo.py:58-84: at a boundary the tail value is the bootstrap
    estimate): a reverse loop over T, vectorised over agents."""
    zero = torch.zeros_like(rewards[0])
    adv_next, ret_next, v_next = zero, zero, zero
    advs = torch.empty_like(rewards)
    rets = torch.empty_like(rewards)
    for t in reversed(range(rewards.shape[0])):
        b, boot = boundaries[t], bootstrap[t]
        v_tail = torch.where(b, boot, v_next)
        ret_tail = torch.where(b, boot, ret_next)
        delta = rewards[t] + gamma * v_tail - values[t]
        adv = delta + gamma * lam * torch.where(b, 0.0, adv_next)
        ret = rewards[t] + gamma * ret_tail
        advs[t], rets[t] = adv, ret
        adv_next, ret_next, v_next = adv, ret, values[t]
    return advs, rets


def _adam_from_jax(opt_state, dtype, device) -> optim.AdamState:
    adam = opt_state[0]
    return optim.AdamState(
        count=torch.as_tensor(np.array(adam.count), dtype=torch.int32,
                              device=device).reshape(-1),
        mu=ac.params_from_jax(adam.mu, dtype, device),
        nu=ac.params_from_jax(adam.nu, dtype, device))


def agent_state_from_jax(st, key_data, dtype: torch.dtype = torch.float64,
                         device=None) -> AgentState:
    """A batched JAX ``AgentState`` (leading agent axis) as the port's:
    params, both optax Adam states, the env state, obs, ep_len, and the
    keys from ``key_data = jax.random.key_data(st.key)`` (uint32 (A, 2))."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return AgentState(
        params=ac.params_from_jax(st.params, dtype, device),
        pi_opt=_adam_from_jax(st.pi_opt, dtype, device),
        vf_opt=_adam_from_jax(st.vf_opt, dtype, device),
        env=EnvState(action=t(st.env.action), timestep=t(st.env.timestep),
                     final_time=t(st.env.final_time)),
        obs=t(st.obs),
        ep_len=torch.as_tensor(np.array(st.ep_len), dtype=torch.int32,
                               device=device),
        key=prng.key_from_data(np.asarray(key_data), device=device))


def state_to(st, device):
    """``st`` (an AgentState, or any NamedTuple / dict of tensors) with
    every tensor moved to ``device``."""
    if isinstance(st, torch.Tensor):
        return st.to(device)
    if isinstance(st, dict):
        return {k: state_to(v, device) for k, v in st.items()}
    return type(st)(*(state_to(v, device) for v in st))


def policy_update(params, pi_opt: optim.AdamState, obs, act, adv,
                  logp_old, *, iters: int, clip_ratio: float, lr: float,
                  target_kl: float):
    """The KL-gated clipped-surrogate loop on (A, T, ...) data; returns
    (params, pi_opt, kl (A,), pi_iters (A,)).  KL is measured at the
    current params and the round that trips the gate applies no update
    (ppo.py:303-314); an agent stops at its first trip or after ``iters``
    applied updates and keeps its state, as under the JAX package's vmapped
    while_loop.  The loss needs only the actor."""
    a_cnt = obs.shape[0]
    names = [k for k in params if k.startswith("pi/")]
    active = torch.full((a_cnt,), iters > 0, dtype=torch.bool,
                        device=obs.device)
    pi_iters = torch.zeros(a_cnt, dtype=torch.int32, device=obs.device)
    kl_out = torch.zeros(a_cnt, dtype=obs.dtype, device=obs.device)
    for _ in range(iters):
        if not bool(active.any()):
            break
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        mu, log_std = ac.actor({**params, **dict(zip(names, leaves))}, obs)
        logp = ac.gaussian_logp(mu, log_std[:, None, :], act)
        ratio = torch.exp(logp - logp_old)
        clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio)
        loss = -torch.minimum(ratio * adv, clipped * adv).mean(1)
        kl = (logp_old - logp).mean(1).detach()
        grads = torch.autograd.grad(loss.sum(), leaves)
        ok = active & (kl <= 1.5 * target_kl)
        params, pi_opt = optim.adam_update(dict(zip(names, grads)), pi_opt,
                                           params, lr, mask=ok)
        pi_iters = pi_iters + ok.to(torch.int32)
        kl_out = torch.where(active, kl, kl_out)
        active = ok & (pi_iters < iters)
    return params, pi_opt, kl_out, pi_iters


def value_regression(params, vf_opt: optim.AdamState, obs, rets, *,
                     iters: int, lr: float):
    """``iters`` optax-Adam steps of the critic on mean((v - ret)^2)
    through autograd (the fori_loop of ppo.py:621-634; the unfused
    counterpart of ops/critic.critic_train)."""
    names = [k for k in params if k.startswith("v/")]
    for _ in range(iters):
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        v = ac.critic({**params, **dict(zip(names, leaves))}, obs)
        loss = ((v - rets) ** 2).mean(1).sum()
        grads = torch.autograd.grad(loss, leaves)
        params, vf_opt = optim.adam_update(dict(zip(names, grads)), vf_opt,
                                           params, lr)
    return params, vf_opt


class PPO_en:
    name = "ppo"

    def __init__(self, nspin=3, in_spin=0, out_spin=2, bmin=-10, bmax=10,
                 max_time=30, repeats=100, fid_threshold=0.98,
                 timestep_res=0.5, epochs=10000, rollouts=4000, log=False,
                 ac_kwargs=None, save=False, timeout=1800, verbose=False,
                 fid_noisy=False, ham_noisy=False, draws=10, adaptive=False,
                 adp_tol=0.05, testing=False, noise=0.05,
                 transfer_learning=False, run_until_told_to_stop=False,
                 run_until_completion_its=6e5,
                 landscape_exploration=False, save_topc=1000,
                 train_pi_iters=200, train_v_iters=200, clip_ratio=0.2,
                 lam=0.97, gamma=0.99, pi_lr=3e-3, vf_lr=1e-3,
                 use_fixed_ham=False, opt_train_size=100,
                 records_update_rate=None, num_agents: int = 1,
                 seed: Optional[int] = None,
                 use_wass_value_targets: bool = False,
                 wass_bootstrap_reps: int = 30,
                 rollout_sweeps: Optional[int] = None,
                 fused_critic: Optional[bool] = None,
                 fused_rollout: Optional[bool] = None,
                 mesh=None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = config.resolve_device(device)
        self.dtype = dtype
        self.nspin = nspin
        self.In = in_spin
        self.Out = out_spin
        self.Bmin, self.Bmax = bmin, bmax
        self.Tmax = max_time
        self.fid_threshold = fid_threshold
        self.fid_noisy = fid_noisy
        self.ham_noisy = ham_noisy
        self.draws = draws
        self.adaptive = adaptive
        self.adp_tol = adp_tol
        self.verbose = verbose
        self.timeout = timeout
        self.save = save
        self.testing = testing
        self.lam, self.gamma = lam, gamma
        self.run_until_told_to_stop = run_until_told_to_stop
        self.run_until_completion_its = run_until_completion_its
        self.landscape_exploration = landscape_exploration
        self.save_topc = save_topc
        self.use_fixed_ham = use_fixed_ham
        self.train_size = opt_train_size
        self.records_update_rate = records_update_rate
        self.num_agents = num_agents
        #: optional parallel.mesh.Mesh over the agent axis (data parallelism
        #: over independent controller searches)
        self.mesh = mesh
        if mesh is not None and num_agents % mesh.devices.size:
            raise ValueError(
                f"num_agents {num_agents} must be a multiple of the mesh "
                f"size {mesh.devices.size}")
        self.use_wass_value_targets = use_wass_value_targets
        self.wass_bootstrap_reps = wass_bootstrap_reps
        #: Jacobi sweeps of the in-rollout reward (None: the dtype's
        #: default; RL reward shaping tolerates ~1e-3, so 4 at float32 is
        #: the throughput mode bench.py uses)
        self.rollout_sweeps = rollout_sweeps
        #: None = on wherever the regime allows (the kernel on the card, its
        #: plain version on the CPU); False = the unfused algorithm
        self.fused_critic = fused_critic
        self.fused_rollout = fused_rollout
        #: called with a stage name at each stage boundary of an epoch
        #: ("start", "rollout", "true_fid", "values", "wass_targets" under
        #: use_wass_value_targets, "pi", "critic"), e.g. to record CUDA
        #: events; None does nothing
        self.stage_hook: Optional[Callable[[str], None]] = None

        # the Experiment driver mutates .env.noise post-construction
        # (noise_analysis.py:343-344), so the env wrapper is the config home
        self.env = Environment(nspin, in_spin, out_spin, np.zeros(nspin),
                               max_time=max_time, bmin=bmin, bmax=bmax,
                               fid_noisy=fid_noisy, ham_noisy=ham_noisy,
                               draws=draws, adaptive=adaptive,
                               adp_tol=adp_tol, noise=noise,
                               transfer_learning=transfer_learning,
                               use_fixed_ham=use_fixed_ham,
                               opt_train_size=opt_train_size, dtype=dtype,
                               device=self.device)

        if seed is None:
            seed = 0 if testing else int(np.random.randint(0, 2**31 - 1))
        self.seed_ = seed

        self.record = {"time_to_get_fid": None, "func_calls": None,
                       "iterations": None, "repeats": None, "best_fid": None,
                       "controller": None}
        self.records = {}
        self.filename = "ppo_en_record_s{}_o{}_t{}_b{}_r_{}.json".format(
            nspin, out_spin, max_time, bmax, repeats)

        # Monte_env capability (ppo.py:179): fidelity re-evaluation helper
        from code_robchar_tpu_torch.models.lbfgs import LBFGS
        self.Monte_env = LBFGS(nspin, in_spin, out_spin, noise=noise,
                               testing=True, device=self.device, dtype=dtype)

    # ----------------------------------------------------------- builders

    def _cfg(self) -> EnvConfig:
        return EnvConfig(n=self.nspin, in_spin=self.In, out_spin=self.Out,
                         bmax=float(self.env.max),
                         maxtime=float(self.env.maxtime),
                         noise=float(self.env.noise),
                         fid_noisy=bool(self.fid_noisy),
                         adaptive=bool(self.adaptive),
                         adp_tol=float(self.adp_tol),
                         ham_noisy=bool(self.ham_noisy),
                         draws=int(self.draws))

    @staticmethod
    def _fused_rollout_gate(use_fixed_ham, fid_noisy):
        """THE fused-rollout gating predicate, shared by the epoch's
        dispatch and the user-facing diagnostic below.  Returns the reasons
        the whole-trajectory rollout cannot run; empty = it runs.  The
        kernel's grid masks any agent count, so there is no tiling
        reason."""
        reasons = []
        if use_fixed_ham:
            reasons.append("fixed-ham ensemble reward (averaged "
                           "propagator has no fused kernel)")
        if fid_noisy:
            reasons.append("shot-noise fidelity (fid_noisy)")
        return reasons

    def fused_rollout_fallback_reasons(self):
        """The reasons the whole-trajectory rollout will NOT be used (the
        same `_fused_rollout_gate` the epoch consumes).  Empty list = the
        fused path runs."""
        return self._fused_rollout_gate(self.use_fixed_ham, self.fid_noisy)

    def _signal_fused_fallbacks(self):
        """One verbose line when the fused rollout is wanted (None or
        True) but the regime turns it off, naming the reason."""
        if not self.verbose or self.fused_rollout is False:
            return
        reasons = self.fused_rollout_fallback_reasons()
        if reasons:
            print("[ppo] fused rollout disabled (" + "; ".join(reasons) +
                  "): falling back to the per-step rollout loop")

    def _stage(self, name: str):
        if self.stage_hook is not None:
            self.stage_hook(name)

    def _sharded(self) -> bool:
        return self.mesh is not None and self.num_agents > 1

    def _build_epoch(self, steps_per_epoch, clip_ratio, pi_lr, vf_lr,
                     max_ep_len, train_pi_iters, train_v_iters, target_kl):
        """One PPO epoch for ALL agents at once, as ``epoch_fn(st) ->
        (st', EpochOut)``.  The drift is taken now; ``self.env.noise`` is
        read at each call (the Experiment driver trains one PPO per sigma
        cell, noise_analysis.py:343-344).  With a mesh (and more than one
        agent) ``st`` is the list of the mesh entries' state blocks
        (parallel.mesh.shard_leading_tree), ``st'`` too, and the EpochOut is
        gathered on the mesh's first device."""
        self._signal_fused_fallbacks()
        args = (steps_per_epoch, clip_ratio, pi_lr, vf_lr, max_ep_len,
                train_pi_iters, train_v_iters, target_kl)
        if not self._sharded():
            return self._build_epoch_impl(*args)
        from code_robchar_tpu_torch.parallel import mesh as pmesh
        mesh = self.mesh
        fns = [pmesh.on_device(self, dev)._build_epoch_impl(*args)
               for dev in mesh.devices]

        def epoch_fn(blocks):
            outs = []
            for dev, fn, st in zip(mesh.devices, fns, blocks):
                with pmesh.on(dev):
                    outs.append(fn(st))
            return ([o[0] for o in outs],
                    pmesh.gather_tree(mesh, [o[1] for o in outs]))
        return epoch_fn

    def _build_epoch_impl(self, steps_per_epoch, clip_ratio, pi_lr, vf_lr,
                          max_ep_len, train_pi_iters, train_v_iters,
                          target_kl):
        """The epoch of ``_build_epoch`` for the agents of one device,
        ``self.device``."""
        cfg = self._cfg()
        n, d = self.nspin, self.nspin + 1
        dt, dev = self.dtype, self.device
        h0 = self.env.sys.to(device=dev, dtype=dt)
        fixed_r = None
        if self.use_fixed_ham:
            fixed = self.env.randH
            fixed_r = (fixed.real if fixed.is_complex() else fixed).to(
                device=dev, dtype=dt)
        gamma, lam = self.gamma, self.lam
        mul = self.train_size if self.use_fixed_ham else 1
        sweeps = (self.rollout_sweeps if self.rollout_sweeps is not None
                  else realform._sweeps_for(dt, n))
        fused_rollout = (self.fused_rollout is not False and
                         not self._fused_rollout_gate(fixed_r is not None,
                                                      cfg.fid_noisy))
        fused_critic = self.fused_critic is not False
        idx = torch.arange(n, device=dev)

        def sym_fid(ar, t):
            return cuda_jacobi.fidelity_sym(ar.contiguous(), t.contiguous(),
                                            cfg.in_spin, cfg.out_spin, sweeps)

        def reward_fixed(action, t):
            """Averaged-PROPAGATOR fixed-ham reward (RLreinforce...:153-162):
            the mean transfer amplitude over the ensemble, agents x
            ensemble in one batch."""
            a_cnt, r_cnt = action.shape[0], fixed_r.shape[0]
            ar = fixed_r.permute(1, 2, 0)[:, :, None, :].expand(
                n, n, a_cnt, r_cnt).clone()
            ar[idx, idx] += action.T[:, :, None]
            phr, phi = cuda_jacobi.transfer_amp_sym(
                ar.reshape(n, n, a_cnt * r_cnt).contiguous(),
                t.repeat_interleave(r_cnt).contiguous(), cfg.in_spin,
                cfg.out_spin, sweeps)
            phr = phr.reshape(a_cnt, r_cnt).mean(-1)
            phi = phi.reshape(a_cnt, r_cnt).mean(-1)
            return phr * phr + phi * phi

        def wass_targets(obs, keys, noise):
            """The Wasserstein cost (T, A) of each visited controller obs
            (T, A, d), from the refreshed agent keys (A, 2)."""
            spec = objectives.ObjectiveSpec(
                h0=h0, in_spin=cfg.in_spin, out_spin=cfg.out_spin,
                noise=noise, fid_noisy=False, ham_noisy=True,
                draws=cfg.draws, adaptive=False, adp_tol=cfg.adp_tol,
                fixed_hams=None, mul_fac=1)
            t_len, a_cnt = obs.shape[:2]
            kw = prng.split(prng.fold_in(keys[0], 11), t_len * a_cnt)
            return objectives.make_wass_cost(spec, self.wass_bootstrap_reps)(
                obs.reshape(t_len * a_cnt, d), kw).reshape(t_len, a_cnt)

        def rollout(st: AgentState, noise: float):
            a_cnt, t_len = st.obs.shape[0], steps_per_epoch
            # ALL epoch randomness from agent 0's key, in batched draws
            # (ppo.py:440-456 of the JAX package)
            k_eps, k_hn, k_shot, key_out = prng.split(st.key[0], 4)
            eps_all = prng.normal(k_eps, (t_len, a_cnt, d), dt)
            zdiag = znn = None
            if cfg.ham_noisy and fixed_r is None:
                zdiag = prng.normal(k_hn, (t_len, a_cnt, n), dt) * noise
                znn = prng.normal(prng.fold_in(k_hn, 1),
                                  (t_len, a_cnt, n - 1), dt) * noise
            keys_out = prng.split(key_out, a_cnt)
            if fused_rollout:
                return rollout_fused(st, eps_all, zdiag, znn, keys_out)
            ks_all = None
            if cfg.fid_noisy:
                ks_all = prng.split(k_shot, t_len * a_cnt).reshape(
                    t_len, a_cnt, 2).to(dev)
            return rollout_steps(st, eps_all, zdiag, znn, ks_all, keys_out)

        def rollout_fused(st, eps_all, zdiag, znn, keys_out):
            a_cnt = st.obs.shape[0]

            def lanes(x):            # (T, A, feat) -> (T, feat, A)
                return None if x is None else x.permute(0, 2, 1).contiguous()

            out = rollout_ops.actor_env_rollout(
                *rollout_ops.fold_actor_weights(st.params), h0.contiguous(),
                st.env.action.T.contiguous(), st.env.timestep.contiguous(),
                st.ep_len.to(torch.int32).contiguous(), lanes(eps_all),
                lanes(zdiag), lanes(znn), in_spin=cfg.in_spin,
                out_spin=cfg.out_spin, sweeps=sweeps, bmax=cfg.bmax,
                maxtime=cfg.maxtime, max_ep_len=int(max_ep_len),
                ham_noisy=cfg.ham_noisy)
            obs2 = out.obs2.permute(0, 2, 1)
            term = out.done | out.timeout
            # pre-step obs: obs_0 from the incoming carry, then obs2 masked
            # by the previous step's terminal reset
            obs0 = torch.cat([st.env.action, st.env.timestep[:, None]], 1)
            obs = torch.cat([obs0[None], obs2[:-1]], dim=0)
            term_prev = torch.cat([torch.zeros_like(term[:1]), term[:-1]])
            obs = torch.where(term_prev[..., None], 0.0, obs)
            action, tstep = out.next_action.T, out.next_t
            env_st = EnvState(action=action, timestep=tstep,
                              final_time=tstep)
            obs_f = torch.cat([action, tstep[:, None]], dim=1)
            traj = (obs, out.a.permute(0, 2, 1), out.fid, obs2, out.done,
                    out.timeout)
            return (env_st, obs_f, out.next_ep, keys_out), traj, None

        def rollout_steps(st, eps_all, zdiag, znn, ks_all, keys_out):
            def policy(obs):
                mu, log_std = ac.actor(st.params, obs[:, None, :])
                return mu[:, 0], torch.exp(log_std)

            # the calls each step bills where the adaptive protocol sets
            # them (ppo.py:548-558 of the JAX package), in step order
            fcalls = []

            def reward(s, new_action, t):
                if fixed_r is not None:
                    fid = reward_fixed(new_action, t)
                else:
                    fid = sym_fid(rollout_ops.hamiltonian_lanes(
                        h0, new_action.T,
                        None if zdiag is None else zdiag[s].T,
                        None if znn is None else znn[s].T), t)
                if not cfg.fid_noisy:
                    return fid
                if cfg.adaptive:
                    fid, extra = noise_ops.adaptive_shot_fidelity(
                        ks_all[s], fid, cfg.draws, cfg.adp_tol)
                    fcalls.append(extra + cfg.draws)
                    return fid
                return noise_ops.shot_noise_fidelity(ks_all[s], fid,
                                                     cfg.draws)

            (action, tstep, ep_len), traj = rollout_ops.rollout_loop(
                policy, reward, st.env.action, st.env.timestep, st.ep_len,
                eps_all, bmax=cfg.bmax, maxtime=cfg.maxtime,
                max_ep_len=max_ep_len)
            env_st = EnvState(action=action, timestep=tstep,
                              final_time=tstep)
            obs_f = torch.cat([action, tstep[:, None]], dim=1)
            steps = torch.stack(fcalls) if fcalls else None
            return (env_st, obs_f, ep_len.to(torch.int32), keys_out), traj, \
                steps

        @trace.spanned("ppo.epoch")
        def epoch(st: AgentState):
            noise = float(self.env.noise)
            self._stage("start")
            with torch.no_grad():
                with trace.span("ppo.rollout"):
                    (env_st, obs_f, ep_len, keys), traj, step_calls = \
                        rollout(st, noise)
                    obs, act, rew, obs2, done, timeout = traj  # (T, A, ...)
                    t_len, a_cnt = rew.shape
                    self._stage("rollout")

                # true fidelities for the whole trajectory in one batch
                with trace.span("ppo.true_fid"):
                    stores = obs2.reshape(t_len * a_cnt, d)
                    true_fid = sym_fid(rollout_ops.hamiltonian_lanes(
                        h0, stores[:, :n].T), stores[:, n])
                    true_fid = true_fid.reshape(t_len, a_cnt)
                    self._stage("true_fid")

                # values and logps of the visited obs, bootstrap values of
                # the next obs, in batched forwards per agent
                with trace.span("ppo.values"):
                    obs_af = obs.transpose(0, 1).contiguous()
                    act_af = act.transpose(0, 1).contiguous()
                    mu, log_std, val = ac.apply(st.params, obs_af)
                    logp = ac.gaussian_logp(mu, log_std[:, None, :], act_af)
                    vboot = ac.critic(st.params, obs2.transpose(0, 1)).T
                    boot = torch.where(done & ~timeout, 0.0, vboot)
                    boundaries = done | timeout
                    # epoch end always closes the open trajectory
                    boundaries[-1] = True
                    with trace.span("ppo.gae"):
                        advs, rets = gae_and_returns(rew, val.T, boundaries,
                                                     boot, gamma, lam)
                    std = advs.std(0, correction=0, keepdim=True)
                    advs = (advs - advs.mean(0, keepdim=True)) / \
                        torch.clamp_min(std, 1e-8)
                    self._stage("values")
                if self.use_wass_value_targets:
                    with trace.span("ppo.wass_targets"):
                        rets = -wass_targets(obs, keys, noise)
                        self._stage("wass_targets")
                rets_af = rets.T.contiguous()

            with trace.span("ppo.pi"):
                params, pi_opt, kl, pi_iters = policy_update(
                    st.params, st.pi_opt, obs_af, act_af,
                    advs.T.contiguous(), logp, iters=train_pi_iters,
                    clip_ratio=clip_ratio, lr=pi_lr, target_kl=target_kl)
                self._stage("pi")
            with trace.span("ppo.critic"):
                if fused_critic:
                    with torch.no_grad():
                        params, vf_opt = critic_ops.critic_train(
                            params, st.vf_opt, obs_af, rets_af,
                            iters=train_v_iters, lr=vf_lr,
                            fast_dot=dev.type == "cuda")
                else:
                    params, vf_opt = value_regression(
                        params, st.vf_opt, obs_af, rets_af,
                        iters=train_v_iters, lr=vf_lr)
                self._stage("critic")
            st = AgentState(params=params, pi_opt=pi_opt, vf_opt=vf_opt,
                            env=env_st, obs=obs_f, ep_len=ep_len, key=keys)
            fcalls = torch.full((a_cnt, t_len), mul, dtype=torch.int32,
                                device=dev)
            if step_calls is not None:
                fcalls = (step_calls.T * mul).to(torch.int32)
            return st, EpochOut(rewards=rew.T, true_fids=true_fid.T,
                                stores=obs2.transpose(0, 1), fcalls=fcalls,
                                kl=kl, pi_iters=pi_iters)

        return epoch

    def _init_agent(self, keys: torch.Tensor) -> AgentState:
        """Fresh agents from their keys, (A, 2) or one key (2,) for A = 1:
        ``split(key)`` gives each agent's parameter key and its carried
        key, as in the JAX package (which vmaps over agents)."""
        keys = keys.reshape(-1, 2)
        ks = prng.split(keys.to(self.device))
        d, dt, dev = self.nspin + 1, self.dtype, self.device
        a_cnt = keys.shape[0]
        params = ac.init_params(ks[:, 0], d, d, dtype=dt, device=dev)
        zeros = torch.zeros(a_cnt, dtype=dt, device=dev)
        return AgentState(
            params=params, pi_opt=optim.adam_init(params),
            vf_opt=optim.adam_init(params),
            env=EnvState(action=torch.zeros((a_cnt, self.nspin), dtype=dt,
                                            device=dev),
                         timestep=zeros,
                         final_time=torch.full_like(zeros,
                                                    float(self.env.maxtime))),
            obs=torch.zeros((a_cnt, d), dtype=dt, device=dev),
            ep_len=torch.zeros(a_cnt, dtype=torch.int32, device=dev),
            key=ks[:, 1])

    # ---------------------------------------------------------------- run

    @trace.spanned("ppo.run")
    def run(self, seed=0, epochs=1000000, steps_per_epoch=500,
            clip_ratio=0.2, pi_lr=3e-3, vf_lr=1e-3, max_ep_len=1000,
            train_pi_iters=200, train_v_iters=200, target_kl=0.01,
            logger_kwargs=None, save_freq=10):
        seed_val = seed if self.testing else self.seed_
        key = prng.key(seed_val)

        epoch_fn = self._build_epoch(steps_per_epoch, clip_ratio, pi_lr,
                                     vf_lr, max_ep_len, train_pi_iters,
                                     train_v_iters, target_kl)

        e = self.num_agents
        st = self._init_agent(key if e == 1 else prng.split(key, e))
        if self._sharded():
            from code_robchar_tpu_torch.parallel import mesh as pmesh
            st = pmesh.shard_leading_tree(self.mesh, st, e)

        deadline = Deadline(self.timeout)
        top = TopControllers(self.save_topc)
        rr = RunRecord(landscape_exploration=self.landscape_exploration,
                       records_update_rate=self.records_update_rate,
                       run_until_completion_its=self.run_until_completion_its)
        self.record = rr.record
        self.records = rr.records

        funcalls = 0
        iterations = 0
        max_fid_seen = 0.0
        best_true = 0.0
        noisy_run = self.ham_noisy or self.fid_noisy

        for epoch_i in range(epochs):
            st, out = epoch_fn(st)
            with trace.span("ppo.fetch"):
                rew = out.rewards.cpu().numpy().reshape(-1)
                true = out.true_fids.cpu().numpy().reshape(-1)
                stores = out.stores.cpu().numpy()
                stores = stores.reshape(-1, self.nspin + 1)
                fc = out.fcalls.cpu().numpy().reshape(-1)
            # the reference's iterations currency counts ONLY the value
            # loop — `iterations += train_v_iters` per epoch (ppo.py:485);
            # one epoch here is e reference runs in lockstep
            iterations += train_v_iters * e

            cum = funcalls + np.cumsum(fc)

            # threshold stop with per-step resolution (ppo.py:441-448)
            if not self.run_until_told_to_stop:
                hits = np.nonzero(rew >= self.fid_threshold)[0]
                funcalls = int(cum[-1])
                m = rew.max()
                if m > max_fid_seen:
                    max_fid_seen = float(m)
                    best_true = float(true[rew.argmax()])
                if hits.size:
                    i = int(hits[0])
                    rr.save(func_calls=int(cum[i]), iterations=iterations,
                            repeats=epoch_i,
                            controller=stores[i].tolist(),
                            best_fid=float(true[i] if noisy_run
                                           else rew[i]), top=None)
                    if self.save:
                        self.save_record()
                    return max_fid_seen
            else:
                # budget stop with per-step resolution (ppo.py:471-478)
                budget = self.run_until_completion_its or np.inf
                over = np.nonzero(cum + 1 >= budget)[0]
                cut = int(over[0]) + 1 if over.size else len(rew)
                if self.landscape_exploration:
                    top.offer_many(rew[:cut], stores[:cut])
                i = int(rew[:cut].argmax())
                if rew[i] > max_fid_seen:
                    max_fid_seen = float(rew[i])
                    best_true = float(true[i])
                prev = rr.record["best_fid"]
                crit = True if self.landscape_exploration else (
                    rew[i] >= (self.fid_threshold if prev is None else prev))
                funcalls = int(cum[cut - 1])
                if crit:
                    rr.save(func_calls=funcalls, iterations=iterations,
                            repeats=epoch_i, controller=stores[i].tolist(),
                            best_fid=float(best_true if noisy_run
                                           else max_fid_seen), top=top)
                if over.size:
                    return max_fid_seen

            if self.verbose:
                print(f"max_fid_obtained: {max_fid_seen}, true_fid: "
                      f"{best_true}, func calls {funcalls}, "
                      f"kl {float(out.kl.mean()):.4f}")
            deadline.check(self.filename)
        return max_fid_seen

    # --------------------------------------------------------- persistence

    def save_record(self):
        from code_robchar_tpu_torch.utils import io
        io.dump_json(self.record, self.filename)

    def read_record(self):
        with open(self.filename) as f:
            return json.load(f)

    def find_min_fid_index(self, controller_list):
        fids = [self.Monte_env.fidelity_ss(c) for c in controller_list]
        return int(np.argmin(fids))
