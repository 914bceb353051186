"""XX spin-chain control environment (counterpart of
code_robchar_tpu/models/env.py).

Reference: RLreinforceXXchain_actionedtime.py:14-276.  The environment is a
pure step function over an explicit EnvState (action bias vector,
accumulated time); a thin stateful ``Environment`` class wraps it for
reference-API parity and for the host-side tests.  The PPO trainer does not
call ``env_step``: its rollout runs the same transition for all agents at
once (ops/rollout.py, which holds the action wrap and the time modulus
this module uses).

Faithful semantics (quirks preserved deliberately):

- actions ACCUMULATE into a diagonal bias; when any |bias| exceeds bmax the
  whole vector wraps by ``b % (sign(b) * bmax)`` (RLreinforce...:261-262),
  ``%`` being the floor remainder whose sign follows the divisor, as
  jnp's and torch's ``%``.
- the time coordinate is |t| mod maxtime when above maxtime
  (RLreinforce...:150-151).
- the reward evolves a FRESH |in> every step (the in-state is reset after
  each step, RLreinforce...:270), so controllers are time-global.
- ``done`` compares the normalised time against the pre-step
  ``final_time`` — with the PPO driver setting final_time = accumulated
  time each step (ppo.py:359-361), episodes effectively only end at epoch
  boundaries (SURVEY.md quirk 9).  Mirrored exactly.
- training-side Hamiltonian noise is the REAL-offdiagonal structured
  perturbation (RLreinforce...:122-133).
- ``use_fixed_ham`` averages the PROPAGATOR over the pre-drawn ensemble
  before applying it (RLreinforce...:153-162) — not the fidelity.

- ``fid_noisy`` puts binomial shot noise on the reward (the adaptive
  protocol when ``adaptive``, billing ``extra + draws`` calls), drawn from
  ``ks`` of ``kh, ks = split(key)``.

Port specifics: dtype and device are explicit, and keys are the port's
threefry keys (the same draws as the JAX package for the same key).  On
the card every fidelity goes through the amplitude kernel
(ops/cuda_jacobi, round-robin pivot order); on the CPU through its plain
version in the JAX package's cyclic order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.ops import chain, cuda_jacobi
from code_robchar_tpu_torch.ops import noise as noise_ops, prng, realform
from code_robchar_tpu_torch.ops.rollout import (
    normalise_time as _normalise_time, wrap_action as _wrap_action)


class EnvConfig(NamedTuple):
    n: int
    in_spin: int
    out_spin: int
    bmax: float
    maxtime: float
    noise: float
    fid_noisy: bool
    ham_noisy: bool
    draws: int
    adaptive: bool
    adp_tol: float


class EnvState(NamedTuple):
    action: torch.Tensor    # (..., n) accumulated diagonal bias
    timestep: torch.Tensor  # (...) accumulated readout time
    final_time: torch.Tensor


def env_reset(cfg: EnvConfig, dtype: torch.dtype = torch.float32,
              device=None) -> Tuple[EnvState, torch.Tensor]:
    state = EnvState(action=torch.zeros(cfg.n, dtype=dtype, device=device),
                     timestep=torch.zeros((), dtype=dtype, device=device),
                     final_time=torch.full((), float(cfg.maxtime),
                                           dtype=dtype, device=device))
    obs = torch.cat([state.action, state.timestep[None]])
    return state, obs


def _transfer_amp(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                  out_spin: int):
    """(phr, phi) of lanes matrices a (n, n, B) and times t (B,): on the
    card the amplitude kernel (round-robin order), on the CPU the plain
    version in the cyclic order of the JAX package's host-side physics."""
    # the cyclic order on the CPU keeps the shot-noise reward within one ulp
    # of the JAX package's (tests/test_torch_env.py,
    # test_shot_noise_raises_naming_its_item, rel=3e-16); the round-robin
    # plain version would agree only to ~1e-10
    if a.device.type == "cpu":
        return realform.transfer_amp_sym_lanes(a, t, in_spin, out_spin,
                                               order="cyclic")
    return cuda_jacobi.transfer_amp_sym(a, t.contiguous(), in_spin, out_spin)


def _fidelity_sym(h: torch.Tensor, t: torch.Tensor, in_spin: int,
                  out_spin: int) -> torch.Tensor:
    """|<out| exp(-i t H) |in>|^2 for real symmetric h (..., n, n) and t
    (...)."""
    lead = h.shape[:-2]
    phr, phi = _transfer_amp(realform._to_lanes(h),
                             t.expand(lead).reshape(-1), in_spin, out_spin)
    return (phr * phr + phi * phi).reshape(lead)


def env_step(cfg: EnvConfig, h0: torch.Tensor, state: EnvState,
             a_bias: torch.Tensor, a_time: torch.Tensor, key: torch.Tensor,
             fixed_hams: Optional[torch.Tensor] = None,
             with_true_fid: bool = True):
    """One control step.  Returns (state', obs, reward, true_fid, done,
    fcalls).  ``h0`` (and ``fixed_hams``) are real symmetric; the draws
    come from ``split(key)``, as in the JAX package: the Hamiltonian noise
    from the first key, the shot noise from the second.
    ``with_true_fid=False`` skips the noiseless fidelity (0 in its slot)."""
    kh, ks = prng.split(key)
    h0 = h0.real if h0.is_complex() else h0
    n = cfg.n
    eye = torch.eye(n, dtype=h0.dtype, device=h0.device)

    action = _wrap_action(state.action + a_bias, cfg.bmax)
    raw_t = state.timestep + a_time
    # the PPO driver pins final_time to the accumulated time (ppo.py:359-361)
    final_time = raw_t
    t = _normalise_time(raw_t, cfg.maxtime)

    hc = h0 + eye * action.to(h0.dtype)

    if fixed_hams is not None:
        # averaged-propagator path (RLreinforce...:153-162): the mean of
        # the per-member transfer amplitudes
        fixed_r = fixed_hams.real if fixed_hams.is_complex() else fixed_hams
        hs = realform._to_lanes(fixed_r.to(h0.dtype) + eye * action)
        phr, phi = _transfer_amp(hs, t.to(h0.dtype).expand(hs.shape[-1]),
                                 cfg.in_spin, cfg.out_spin)
        amp_r, amp_i = phr.mean(), phi.mean()
        fid = amp_r * amp_r + amp_i * amp_i
    else:
        h = hc
        if cfg.ham_noisy:
            zr, _ = noise_ops.structured_perturbation_parts(
                kh.to(h0.device), n, cfg.noise, complex_offdiag=False,
                dtype=h.dtype)
            h = h + zr
        fid = _fidelity_sym(h, t, cfg.in_spin, cfg.out_spin)

    if with_true_fid:
        true_fid = _fidelity_sym(hc, t, cfg.in_spin, cfg.out_spin)
    else:
        true_fid = torch.zeros((), dtype=h0.dtype, device=h0.device)

    fcalls = torch.ones((), dtype=torch.int32, device=h0.device)
    reward = fid
    if cfg.fid_noisy:
        ks = ks.to(h0.device)
        if cfg.adaptive:
            reward, extra = noise_ops.adaptive_shot_fidelity(
                ks, fid, cfg.draws, cfg.adp_tol)
            fcalls = (extra + cfg.draws).to(torch.int32)
        else:
            reward = noise_ops.shot_noise_fidelity(ks, fid, cfg.draws)

    done = t > final_time
    state = EnvState(action=action, timestep=t, final_time=final_time)
    obs = torch.cat([action, t[None]])
    return state, obs, reward, true_fid, done, fcalls


def true_fidelity_batch(cfg: EnvConfig, h0: torch.Tensor,
                        stores: torch.Tensor) -> torch.Tensor:
    """Noiseless fidelities of a (T, n+1) trajectory of controller
    snapshots (action biases + time)."""
    n = cfg.n
    eye = torch.eye(n, dtype=h0.dtype, device=h0.device)
    h = h0 + eye * stores[:, None, :n]
    return _fidelity_sym(h, stores[:, n], cfg.in_spin, cfg.out_spin)


class Environment:
    """Stateful reference-API wrapper (reset/step/fidelity/true_fid) around
    the pure step; the PPO trainer's config home (it reads ``noise``,
    ``sys`` and ``randH`` from here at run time)."""

    def __init__(self, nspin, in_spin, out_spin, action_vector=None,
                 final_time=6, topo="linear", timestep_res=0.01, max_time=30,
                 bmin=-20, bmax=20, fid_noisy=False, ham_noisy=False,
                 draws=20, adaptive=False, adp_tol=0.05, noise=0.05,
                 transfer_learning=False, heisenberg_int=False,
                 use_fixed_ham=False, opt_train_size=100, seed=0,
                 dtype: torch.dtype = torch.float32, device=None):
        self.Nspin = nspin
        self.in_spin = in_spin
        self.out_spin = out_spin
        self.noise = noise
        self.maxtime = max_time
        self.max = bmax
        self.min = bmin
        self.tres = timestep_res
        self.use_fixed_ham = use_fixed_ham
        self.train_size = opt_train_size
        self.draws = draws
        self.adaptive = adaptive
        self.adp_var_tol = adp_tol
        self.fid_noisy = fid_noisy
        self.ham_noisy = ham_noisy
        self.topo = topo
        self.heisenberg_int = heisenberg_int
        self.dtype = dtype
        self.device = config.resolve_device(device)
        self._key = prng.key(seed)

        self.sys = self._drift()
        if transfer_learning:
            # perturbed system with its diagonal masked off
            # (RLreinforce...:30-35)
            self.sys = self._masked_perturbed(self.sys)

        if use_fixed_ham:
            self.randH, self.randH_test = noise_ops.fixed_hamiltonian_ensemble(
                prng.key(4), self.sys, self.noise,
                train_size=self.train_size, test_size=10000,
                complex_offdiag=False)
        else:
            self.randH = self.randH_test = None

        self.timestep = 0.0
        self.final_time = float(self.maxtime)
        self.action = np.zeros(nspin)
        self.adp_func_calls_increment = draws
        self.tf = 0.0

    def _drift(self) -> torch.Tensor:
        return chain.xx_hamiltonian_real(
            self.Nspin, topo=self.topo, heisenberg=self.heisenberg_int,
            dtype=self.dtype, device=self.device)

    def _masked_perturbed(self, drift: torch.Tensor) -> torch.Tensor:
        pert, _ = noise_ops.structured_perturbation_parts(
            self._next().to(self.device), self.Nspin, 0.1,
            complex_offdiag=False, dtype=self.dtype)
        mask = 1.0 - torch.eye(self.Nspin, dtype=self.dtype,
                               device=self.device)
        return (drift + pert) * mask

    def _next(self) -> torch.Tensor:
        self._key, k = prng.split(self._key)
        return k

    def _cfg(self) -> EnvConfig:
        return EnvConfig(n=self.Nspin, in_spin=self.in_spin,
                         out_spin=self.out_spin, bmax=float(self.max),
                         maxtime=float(self.maxtime),
                         noise=float(self.noise),
                         fid_noisy=bool(self.fid_noisy),
                         ham_noisy=bool(self.ham_noisy),
                         draws=int(self.draws), adaptive=bool(self.adaptive),
                         adp_tol=float(self.adp_var_tol))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                               device=self.device)

    def _state(self) -> EnvState:
        return EnvState(action=self._tensor(self.action),
                        timestep=self._tensor(0.0),
                        final_time=self._tensor(float(self.final_time)))

    def reset(self):
        self.timestep = 0.0
        self.final_time = float(self.maxtime)
        self.action = np.zeros(self.Nspin)
        return np.diag(self.action)

    def step(self, action_matrix):
        """action_matrix: (n, n) diagonal increment (the reference passes
        np.diag(a)); time increments are applied by mutating .timestep
        before the call, as the PPO driver does (ppo.py:359-363)."""
        a_bias = self._tensor(np.diag(np.asarray(action_matrix)))
        st, _, reward, true_fid, done, _ = env_step(
            self._cfg(), self.sys, self._state(), a_bias,
            self._tensor(self.timestep), self._next(),
            fixed_hams=self.randH if self.use_fixed_ham else None)
        self.action = st.action.cpu().numpy()
        self.timestep = float(st.timestep)
        self.tf = float(true_fid)
        return np.diag(self.action), float(reward), bool(done)

    def fidelity(self):
        _, _, reward, _, _, _ = env_step(
            self._cfg(), self.sys, self._state(),
            torch.zeros(self.Nspin, dtype=self.dtype, device=self.device),
            self._tensor(self.timestep), self._next(),
            fixed_hams=self.randH if self.use_fixed_ham else None)
        return float(reward)

    def structured_perturabation(self, noise):  # reference spelling
        """A real structured perturbation of width ``noise`` from the env's
        key stream: complex (n, n) on the env's device, real off the
        diagonal (complex_offdiag=False)."""
        return noise_ops.structured_perturbation(
            self._next().to(self.device), self.Nspin, noise,
            complex_offdiag=False, dtype=config.complex_dtype(self.dtype))

    # ----------------------- reference-API capability shims ----------------

    def state_vector(self, occ):
        return chain.basis_state(self.Nspin, occ,
                                 dtype=torch.float64).numpy()

    def input_state(self):
        rho = np.zeros((self.Nspin, self.Nspin))
        rho[self.in_spin, self.in_spin] = 1
        return rho

    def output_state(self):
        rho = np.zeros((self.Nspin, self.Nspin))
        rho[self.out_spin, self.out_spin] = 1
        return rho

    def reinit_sys_hamiltonian(self):
        """Re-draw the masked perturbed system of transfer-learning mode
        (RLreinforce...:75-80), honouring the env's topology and
        interaction."""
        self.sys = self._masked_perturbed(self._drift())

    def change_sys_ham(self, default_variation: float = 0.1):
        """Perturb the system's couplings in place (RLreinforce...:136-143:
        small Gaussian bumps on nearest-neighbour couplings)."""
        nn, _ = noise_ops.structured_perturbation_parts(
            self._next().to(self.device), self.Nspin, default_variation,
            complex_offdiag=False, dtype=self.dtype)
        self.sys = self.sys + (nn - torch.diag(torch.diag(nn)))

    def normalize(self):
        """Wrap action/time back into bounds (RLreinforce...:253-257)."""
        a = np.asarray(self.action)
        if (np.abs(a) > self.max).any():
            self.action = _wrap_action(self._tensor(a),
                                       float(self.max)).cpu().numpy()
        self.timestep = float(_normalise_time(
            self._tensor(abs(self.timestep)), float(self.maxtime)))

    def true_fid(self, action_matrix, timestep_n=None):
        t = self.timestep if timestep_n is None else timestep_n
        a = self._tensor(np.diag(np.asarray(action_matrix)))
        eye = torch.eye(self.Nspin, dtype=self.dtype, device=self.device)
        return float(_fidelity_sym(self.sys + eye * a, self._tensor(float(t)),
                                   self.in_spin, self.out_spin))
