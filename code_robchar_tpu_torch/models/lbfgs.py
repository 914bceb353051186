"""Batched bound-constrained L-BFGS controller search (counterpart of
code_robchar_tpu/models/lbfgs.py).

Replaces the reference's multi-start loop over scipy's Fortran L-BFGS-B
(qnewton.py:464-632): the restarts of a pool advance together, a
``lane_width``-wide batch of them at a time.  Per restart: projected
two-loop-recursion L-BFGS with box projection and Armijo backtracking
(not a literal L-BFGS-B; the parity contract is budget-matched outcome
distributions, SURVEY.md §7.4).

Lane recycling (``_batched_restarts``): a restart that terminates
scatters its result into the per-restart buffers and its lane is refilled
with the next pool start in the same round, so the round count tracks the
mean restart length.  Every line-search trial is one evaluation of the
whole lane batch: the exact-gradient kernel when noiseless, the amplitude
kernel under forward differences when noisy.

The JAX package runs the rounds and the line search as ``lax.while_loop``s.
Here they are host loops over device-side masks: the exit condition is
read every round (and every line-search trial after the first) exactly as
JAX evaluates it, since in the noisy regimes the number of trials decides
how often the key is split.  Each read is one host sync; ``stats`` counts
rounds, trials and syncs.  The masked scatters write through a dummy row R
(``index_copy_``), as JAX's ``.at[tgt].set(mode="drop")``.

Function-call accounting mirrors qnewton.py:496-569, including the
reference's double billing of d["funcalls"] in the non-adaptive path
(:558 adds d["funcalls"]*mul_fac and :562 adds d["funcalls"] again).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.models.base import BatchResult, ControlOptimizer
from code_robchar_tpu_torch.ops import prng
from code_robchar_tpu_torch.utils import trace

_M = 10          # history pairs (scipy default)
_C1 = 1e-4       # Armijo sufficient decrease
_MAX_BACKTRACK = 20
_PGTOL = 1e-5
_FTOL = 2.2e-9   # factr * eps, scipy default factr=1e7

#: restarts in flight per round (the JAX package's lane width)
_DEFAULT_LANES = 1024


def _two_loop_batch(g, s_hist, y_hist, rho, hist_len):
    """Two-loop recursion over rolling histories, batched: g (K, d),
    s_hist/y_hist (K, m, d), rho (K, m), hist_len (K,) -> direction (K, d)
    (newest pair at index 0)."""
    m = s_hist.shape[1]
    q = g
    alphas = []
    for i in range(m):
        valid = i < hist_len
        alpha = torch.where(valid, rho[:, i] * (s_hist[:, i] * q).sum(-1),
                            0.0)
        q = q - alpha[:, None] * y_hist[:, i]
        alphas.append(alpha)

    # initial Hessian scaling gamma = s.y / y.y of the newest pair
    sy = (s_hist[:, 0] * y_hist[:, 0]).sum(-1)
    yy = (y_hist[:, 0] * y_hist[:, 0]).sum(-1)
    gamma = torch.where((hist_len > 0) & (yy > 0),
                        sy / torch.clamp_min(yy, 1e-30), 1.0)
    r = gamma[:, None] * q
    for i in reversed(range(m)):
        valid = i < hist_len
        beta = torch.where(valid, rho[:, i] * (y_hist[:, i] * r).sum(-1),
                           0.0)
        r = r + torch.where(valid, alphas[i] - beta, 0.0)[:, None] \
            * s_hist[:, i]
    return -r


def _push_history_batch(s_hist, y_hist, rho, hist_len, s, y, update):
    """Masked per-lane history push: lanes with ``update`` False (frozen)
    or a non-curvature pair (s.y <= 1e-10) keep their history."""
    sy = (s * y).sum(-1)
    accept = update & (sy > 1e-10)
    s2 = torch.cat([s[:, None], s_hist[:, :-1]], dim=1)
    y2 = torch.cat([y[:, None], y_hist[:, :-1]], dim=1)
    r2 = torch.cat([(1.0 / torch.where(accept, sy, 1.0))[:, None],
                    rho[:, :-1]], dim=1)
    a = accept[:, None, None]
    return (torch.where(a, s2, s_hist), torch.where(a, y2, y_hist),
            torch.where(accept[:, None], r2, rho),
            torch.where(accept, torch.clamp_max(hist_len + 1,
                                                s_hist.shape[1]), hist_len))


class _PoolResult(NamedTuple):
    x: torch.Tensor      # (R, d) final iterate per restart
    f: torch.Tensor      # (R,)
    nfev: torch.Tensor   # (R,)
    nit: torch.Tensor    # (R,)
    rounds: int          # outer rounds (L-BFGS steps of the lane batch)
    trials: int          # line-search trials, i.e. objective evaluations
    syncs: int           # host reads of a device-side exit condition


def _batched_restarts(x0_pool, key, value_and_grad_b, lower, upper, maxiter,
                      maxfun, lanes=None, calls_per_eval=1):
    """All restarts of ``x0_pool`` (R, d) with lane recycling on a
    ``L = min(lanes, R)``-wide batch; ``value_and_grad_b(xs, key) ->
    (f (L,), g (L, d), billed calls (L,))``.

    The line search keeps the accepted candidate's gradient (scipy's dcsrch
    evaluates fun and grad at every trial), so no evaluation runs after it.
    A refilled lane spends one round "fresh": it skips the step and takes
    its initial (f, g) from the round's first trial.  ``maxfun`` gates on
    objective calls (``calls_per_eval`` per evaluation: d+1 for finite
    differences, 1 exact), not on billed calls."""
    R, d = x0_pool.shape
    L = int(min(lanes or _DEFAULT_LANES, R))
    dev, dt = x0_pool.device, x0_pool.dtype
    i32 = dict(dtype=torch.int32, device=dev)

    def clip(x):
        return torch.clamp(x, lower, upper)

    def proj_grad_norm(x, g):
        pg = torch.where((x <= lower) & (g > 0), 0.0, g)
        pg = torch.where((x >= upper) & (pg < 0), 0.0, pg)
        return pg.abs().amax(-1)

    x = x0_pool[:L].clone()
    f = torch.zeros(L, dtype=dt, device=dev)
    g = torch.zeros((L, d), dtype=dt, device=dev)
    s_hist = torch.zeros((L, _M, d), dtype=dt, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((L, _M), dtype=dt, device=dev)
    hist_len = torch.zeros(L, **i32)
    nfev = torch.zeros(L, **i32)
    ncall = torch.zeros(L, **i32)
    nit = torch.zeros(L, **i32)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    idx = torch.arange(L, device=dev)
    live = torch.ones(L, dtype=torch.bool, device=dev)
    fresh = torch.ones(L, dtype=torch.bool, device=dev)
    next_i = torch.tensor(L, device=dev)
    out_x = torch.zeros((R + 1, d), dtype=dt, device=dev)
    out_f = torch.zeros(R + 1, dtype=dt, device=dev)
    out_nfev = torch.zeros(R + 1, **i32)
    out_nit = torch.zeros(R + 1, **i32)
    rounds = trials = syncs = 0

    while True:
        syncs += 1
        with trace.span("lbfgs.sync"):
            any_live = bool(live.any())
        if not any_live:
            break
        rounds += 1
        with trace.span("lbfgs.round"):
            active = live & ~fresh
            direction = _two_loop_batch(g, s_hist, y_hist, rho, hist_len)
            gd = (g * direction).sum(-1)
            direction = torch.where((gd < 0)[:, None], direction, -g)

            # Armijo backtracking with box projection: each trial evaluates
            # one candidate per lane, and the search ends once every active
            # lane has accepted.  Fresh lanes (direction 0, so the candidate is
            # their start) take their initial (f, g) from the first trial,
            # which therefore always runs (active | fresh == live here).
            need_fresh = fresh & live
            step = torch.ones(L, dtype=dt, device=dev)
            x_new, f_new, g_new = x, f, g
            accepted = torch.zeros(L, dtype=torch.bool, device=dev)
            tries = 0
            while True:
                with trace.span("lbfgs.trial"):
                    key, kk = prng.split(key)
                    cands = clip(x + step[:, None] * direction)
                    fc, gc, cc = value_and_grad_b(cands, kk)
                    dd = (g * (cands - x)).sum(-1)
                    ok = fc <= f + _C1 * dd
                    take = ~accepted & active
                    fresh_now = (need_fresh if tries == 0
                                 else torch.zeros_like(live))
                    got = (take & ok) | fresh_now
                    x_new = torch.where((take & ok)[:, None], cands, x_new)
                    f_new = torch.where(got, fc, f_new)
                    g_new = torch.where(got[:, None], gc, g_new)
                    accepted = accepted | (ok & active)
                    billed = take | fresh_now
                    nfev = nfev + torch.where(billed, cc, 0)
                    ncall = ncall + torch.where(billed, calls_per_eval, 0)
                    step = torch.where(take, step * 0.5, step)
                    tries += 1
                    trials += 1
                    if tries >= _MAX_BACKTRACK:
                        break
                    syncs += 1
                    with trace.span("lbfgs.sync"):
                        pending = bool((~accepted & active).any())
                    if not pending:
                        break

            s = x_new - x
            y = g_new - g
            s_hist, y_hist, rho, hist_len = _push_history_batch(
                s_hist, y_hist, rho, hist_len, s, y, active & accepted)

            converged = (proj_grad_norm(x_new, g_new) < _PGTOL) | \
                ((f - f_new).abs() <= _FTOL * torch.clamp_min(
                    torch.maximum(f.abs(), f_new.abs()), 1.0)) | ~accepted

            upd = active & accepted
            x_cur = torch.where(upd[:, None], x_new, x)
            f_cur = torch.where(fresh | upd, f_new, f)
            g_cur = torch.where((fresh | upd)[:, None], g_new, g)
            nit = nit + active.to(torch.int32)
            done = done | (converged & active)
            finished = active & (done | (nit >= maxiter) | (ncall >= maxfun))

            # scatter finished restarts into the output buffers (dummy row R
            # takes the unfinished lanes' writes)
            tgt = torch.where(finished, idx, R)
            out_x.index_copy_(0, tgt, x_cur)
            out_f.index_copy_(0, tgt, f_cur)
            out_nfev.index_copy_(0, tgt, nfev)
            out_nit.index_copy_(0, tgt, nit)

            # refill finished lanes with the next unassigned pool starts
            slot = next_i + torch.cumsum(finished, 0) - 1
            refill = finished & (slot < R)
            slot_c = torch.clamp_max(slot, R - 1)
            rz = refill[:, None]
            x = torch.where(rz, x0_pool[slot_c], x_cur)
            f = torch.where(refill, 0.0, f_cur)
            g = torch.where(rz, 0.0, g_cur)
            s_hist = torch.where(rz[:, :, None], 0.0, s_hist)
            y_hist = torch.where(rz[:, :, None], 0.0, y_hist)
            rho = torch.where(rz, 0.0, rho)
            hist_len = torch.where(refill, 0, hist_len)
            nfev = torch.where(refill, 0, nfev)
            ncall = torch.where(refill, 0, ncall)
            nit = torch.where(refill, 0, nit)
            done = done & ~refill
            idx = torch.where(refill, slot_c, idx)
            live = (live & ~finished) | refill
            fresh = refill
            next_i = next_i + finished.sum()

    return _PoolResult(out_x[:R], out_f[:R], out_nfev[:R], out_nit[:R],
                       rounds, trials, syncs)


class LBFGS(ControlOptimizer):
    name = "lbfgs"
    budget_per_restart = 120  # typical converged nfev; batch-size heuristic
    supports_wass_cost = True
    # lane recycling keeps the evaluation batch lane_width wide, so a
    # dispatch takes a large pool
    default_batch = 4096

    def __init__(self, *args, maxiter: int = 200,
                 lane_width: int = _DEFAULT_LANES, **kwargs):
        super().__init__(*args, **kwargs)
        self.maxiter = maxiter
        self.lane_width = lane_width

    def _batch_fn(self):
        """(x0s (K, d), keys (K, 2)) -> BatchResult for the current noise
        config; raises for the combinations the reference leaves
        undefined."""
        noisy = self.fid_noisy or self.ham_noisy
        use_fixed = self.use_fixed_ham
        use_wass = self.use_wass_cost
        d = self.Nspin + 1
        # scipy's maxfun: 500 when noisy (qnewton.py:513-514), its default
        # 15000 when noiseless
        maxfun = 500 if noisy else 15000
        if noisy and use_wass and use_fixed:
            raise NotImplementedError(
                "use_wass_cost with use_fixed_ham is undefined: the wass "
                "cost probes fresh ham noise (qnewton.py:447-455) and "
                "never consults the fixed ensemble")
        if not noisy and use_wass:
            raise NotImplementedError(
                "use_wass_cost requires a noisy run (fid_noisy or "
                "ham_noisy): the cost probes ham-noisy fidelity at "
                "sigma=noise (qnewton.py:447-455) and the reference's "
                "noiseless branch never consults the flag")
        # maxfun counts objective calls: d+1 per finite-difference
        # evaluation, 1 per exact one
        calls_per_eval = (d + 1) if noisy else 1
        # reference fcall accounting (module docstring): non-adaptive
        # restarts bill d["funcalls"] * (mul_fac + 1); the wass path bills
        # bootstrap_reps per objective call in-band; the noiseless branch
        # never consults the fixed ensemble, so mul_fac = 1 there
        if noisy and use_wass:
            bill_mul = 1
        elif not noisy:
            bill_mul = 2
        else:
            bill_mul = (self.train_size if use_fixed else 1) + \
                (0 if self.adaptive else 1)

        spec = self.spec()
        if noisy:
            inner = (objectives.make_wass_cost_batch(spec, 5) if use_wass
                     else objectives.make_infidelity_batch(spec))
            vag_b = objectives.make_fd_gradient_batch(inner, d)
        else:
            exact_b = objectives.make_exact_gradient_batch(spec)

            def vag_b(xs, key):
                errs, grads = exact_b(xs)
                return errs, grads, torch.ones(
                    xs.shape[0], dtype=torch.int32, device=xs.device)

        def run_batch(x0s, keys):
            st = _batched_restarts(x0s, keys[0], vag_b, self._lower,
                                   self._upper, self.maxiter, maxfun,
                                   lanes=self.lane_width,
                                   calls_per_eval=calls_per_eval)
            self.stats = {"rounds": st.rounds, "trials": st.trials,
                          "syncs": st.syncs}
            if use_fixed:
                # reference: fi = true_fid = 1 - f under fixed-ham
                # (qnewton.py:527-530)
                fids = trues = 1.0 - st.f
            else:
                # fresh noisy re-evaluation + clean fidelity
                # (qnewton.py:533-535)
                e, _ = objectives.make_infidelity_batch(spec)(
                    st.x, prng.fold_in(keys[0], 1))
                fids = 1.0 - e
                trues = objectives.fidelity_batch(self.HH, st.x, self.In,
                                                  self.Out)
            return BatchResult(st.x, fids, trues, st.nfev * bill_mul, st.nit)
        return run_batch

    def _run_batch(self, x0s, keys) -> BatchResult:
        return self._batch_fn()(x0s, keys)
