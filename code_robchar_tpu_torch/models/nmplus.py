"""Batched Nelder-Mead controller search, NMPlus (counterpart of
code_robchar_tpu/models/nmplus.py, its lane-recycled production path).

Reference: nmplus.py — multi-start scipy Nelder-Mead with bounds and a
300-objective-eval budget per restart (nmplus.py:210-228).  Standard
coefficients alpha=1, gamma=2 (expand), rho=0.5 (contract), sigma=0.5
(shrink); bounds enforced by clipping candidates into the box.

fcall accounting: nfev counts the evaluations the sequential algorithm
would make (x.nfev in the reference, nmplus.py:251-256), multiplied by
train_size under fixed-ham; the reference's NM never bills adaptive shot
draws, so nfev is a pure evaluation count in every regime.

The JAX package runs the rounds as a ``lax.while_loop``; here they are a
host loop over device-side masks that reads the exit condition (any lane
live) every round, one host sync each (``stats``).  The single-stream
``_nm_while`` (stagnation restarts), ``run_accelerated`` and the
benchmark objectives are not ported yet.
"""

from __future__ import annotations

import math

import torch

from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.models.base import BatchResult, ControlOptimizer
from code_robchar_tpu_torch.models.lbfgs import _DEFAULT_LANES
from code_robchar_tpu_torch.ops import prng

_ALPHA, _GAMMA, _RHO, _SIGMA = 1.0, 2.0, 0.5, 0.5


def _nm_while_batched(simplex0_pool, key, infid_b, lower, upper, maxfev,
                      xatol=1e-4, fatol=1e-4, lanes=None):
    """All restarts of ``simplex0_pool`` (R, d+1, d) with lane recycling on
    a ``L = min(lanes, R)``-wide batch; ``infid_b(xs, key) -> (f, calls)``.
    Returns (best_x (R, d), best_f (R,), nfev (R,), nit (R,), stats).

    One evaluation batch per round, (L, max(4, d+1)) points: active lanes
    fill slots 0..3 with [reflection, expansion, outside contraction,
    inside contraction] (the sequential algorithm consults at most two;
    the others are not billed), while pending lanes — just refilled, or
    whose last round decided a shrink — fill slots 0..d with their
    unevaluated vertices.  A shrink is billed when decided (d evaluations)
    and a refill at its pending round (d+1), as the sequential algorithm
    would."""
    R, dp1, d = simplex0_pool.shape
    L = int(min(lanes or _DEFAULT_LANES, R))
    m = max(4, dp1)
    dev, dt = simplex0_pool.device, simplex0_pool.dtype
    i32 = dict(dtype=torch.int32, device=dev)

    def clip(x):
        return torch.clamp(x, lower, upper)

    def searching_of(simplex, fvals, ncall):
        # maxfev gates on objective calls (scipy NM counts evaluations)
        spread_f = (fvals - fvals[:, :1]).abs().amax(1)
        spread_x = (simplex - simplex[:, :1]).abs().amax((1, 2))
        return (ncall < maxfev) & ((spread_f > fatol) | (spread_x > xatol))

    simplex_in = simplex0_pool[:L].clone()
    fvals_in = torch.zeros((L, dp1), dtype=dt, device=dev)
    nfev = torch.zeros(L, **i32)
    ncall = torch.zeros(L, **i32)
    nit = torch.zeros(L, **i32)
    idx = torch.arange(L, device=dev)
    live = torch.ones(L, dtype=torch.bool, device=dev)
    pending = torch.ones(L, dtype=torch.bool, device=dev)
    billinit = torch.ones(L, dtype=torch.bool, device=dev)
    next_i = torch.tensor(L, device=dev)
    out_s = torch.zeros((R + 1, dp1, d), dtype=dt, device=dev)
    out_f = torch.zeros((R + 1, dp1), dtype=dt, device=dev)
    out_nfev = torch.zeros(R + 1, **i32)
    out_nit = torch.zeros(R + 1, **i32)
    rounds = syncs = 0

    while True:
        syncs += 1
        if not bool(live.any()):
            break
        rounds += 1
        active = live & ~pending
        order = torch.argsort(fvals_in, dim=1, stable=True)
        simplex = torch.take_along_dim(simplex_in, order[:, :, None], dim=1)
        fvals = torch.take_along_dim(fvals_in, order, dim=1)
        centroid = simplex[:, :-1].sum(1) / d
        worst = simplex[:, -1]

        xr = clip(centroid + _ALPHA * (centroid - worst))
        xe = clip(centroid + _GAMMA * (xr - centroid))
        xc_out = clip(centroid + _RHO * (xr - centroid))
        xc_in = clip(centroid - _RHO * (centroid - worst))

        # the round's single evaluation batch
        cand_mat = torch.cat(
            [torch.stack([xr, xe, xc_out, xc_in], dim=1),
             xr[:, None, :].expand(L, m - 4, d)], dim=1)
        pend_mat = torch.cat(
            [simplex_in, simplex_in[:, :1].expand(L, m - dp1, d)], dim=1)
        eval_mat = torch.where(pending[:, None, None], pend_mat, cand_mat)
        key, kc = prng.split(key)
        fs, _ = infid_b(eval_mat.reshape(L * m, d), kc)
        fs = fs.reshape(L, m)
        fr, fe, fc_out, fc_in = fs[:, 0], fs[:, 1], fs[:, 2], fs[:, 3]

        f_best = fvals[:, 0]
        f_second_worst = fvals[:, -2]
        f_worst = fvals[:, -1]

        use_expand = (fr < f_best) & (fe < fr)
        use_reflect = (fr < f_second_worst) & ~use_expand
        use_contract_out = (~use_expand & ~use_reflect &
                            (fr < f_worst) & (fc_out <= fr))
        use_contract_in = (~use_expand & ~use_reflect & (fr >= f_worst) &
                           (fc_in < f_worst))
        shrink = ~(use_expand | use_reflect | use_contract_out |
                   use_contract_in)

        new_point = torch.where(
            use_expand[:, None], xe, torch.where(
                use_reflect[:, None], xr, torch.where(
                    use_contract_out[:, None], xc_out, torch.where(
                        use_contract_in[:, None], xc_in, worst))))
        new_f = torch.where(
            use_expand, fe, torch.where(
                use_reflect, fr, torch.where(
                    use_contract_out, fc_out, torch.where(
                        use_contract_in, fc_in, f_worst))))
        simplex = torch.cat([simplex[:, :-1], new_point[:, None]], dim=1)
        fvals = torch.cat([fvals[:, :-1], new_f[:, None]], dim=1)

        # a shrinking lane moves its vertices now and evaluates them in the
        # next round's batch
        shrunk = simplex[:, :1] + _SIGMA * (simplex - simplex[:, :1])
        simplex = torch.where(shrink[:, None, None], shrunk, simplex)

        # bill what the sequential algorithm evaluates: reflect always;
        # expand when fr < f_best; one contraction when neither is
        # accepted; d re-evaluations on shrink; d+1 at a refill's pending
        # round
        seq_evals = (1 + (fr < f_best).to(torch.int32)
                     + (~use_expand & ~use_reflect).to(torch.int32)
                     + shrink.to(torch.int32) * (dp1 - 1))
        init_pend = (pending & billinit).to(torch.int32) * dp1
        bill = torch.where(active, seq_evals, init_pend)
        nfev = nfev + bill
        ncall = ncall + bill

        simplex = torch.where(active[:, None, None], simplex, simplex_in)
        fvals = torch.where(active[:, None], fvals,
                            torch.where(pending[:, None], fs[:, :dp1],
                                        fvals_in))
        nit = nit + active.to(torch.int32)
        pend_next = active & shrink

        # termination on current values only: a lane that just went
        # pending checks at its next round
        finished = live & ~pend_next & ~searching_of(simplex, fvals, ncall)

        tgt = torch.where(finished, idx, R)
        out_s.index_copy_(0, tgt, simplex)
        out_f.index_copy_(0, tgt, fvals)
        out_nfev.index_copy_(0, tgt, nfev)
        out_nit.index_copy_(0, tgt, nit)

        # refill finished lanes with the next unassigned pool starts
        slot = next_i + torch.cumsum(finished, 0) - 1
        refill = finished & (slot < R)
        slot_c = torch.clamp_max(slot, R - 1)
        simplex_in = torch.where(refill[:, None, None],
                                 simplex0_pool[slot_c], simplex)
        fvals_in = torch.where(refill[:, None], 0.0, fvals)
        nfev = torch.where(refill, 0, nfev)
        ncall = torch.where(refill, 0, ncall)
        nit = torch.where(refill, 0, nit)
        idx = torch.where(refill, slot_c, idx)
        live = (live & ~finished) | refill
        pending = pend_next | refill
        billinit = refill
        next_i = next_i + finished.sum()

    simplex, fvals = out_s[:R], out_f[:R]
    best_i = torch.argmin(fvals, dim=1)
    best_x = torch.take_along_dim(simplex, best_i[:, None, None], dim=1)[:, 0]
    best_f = torch.take_along_dim(fvals, best_i[:, None], dim=1)[:, 0]
    return best_x, best_f, out_nfev[:R], out_nit[:R], {
        "rounds": rounds, "syncs": syncs}


def regular_simplex(x0: torch.Tensor, lower, upper, key) -> torch.Tensor:
    """Regular-simplex initialisation in the box around random magnitudes
    (the reference's accelerated-NM init_simplex, nmplus.py:20-36): vertex
    i > 0 displaces coordinate i-1 by the regular-simplex ratio, all
    vertices clipped into bounds.  ``key`` is a prng key; the magnitudes
    are the words of jax.random.uniform in x0's dtype."""
    d = x0.shape[0]
    a = (math.sqrt(d + 1.0) + d - 1) / (d * math.sqrt(2.0))
    b = (math.sqrt(d + 1.0) - 1) / (d * math.sqrt(2.0))
    scale = prng.uniform(key, (d,), x0.dtype).to(x0.device) \
        * (upper - lower) * 0.1
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    verts = [x0] + [x0 + scale * (b + (a - b) * eye[i]) for i in range(d)]
    return torch.clamp(torch.stack(verts), lower, upper)


class NMPlus(ControlOptimizer):
    name = "nmplus"
    budget_per_restart = 300
    # lane recycling: big pools amortize the straggler tail
    default_batch = 2048
    default_lane_width = 1024

    def __init__(self, *args, maxfev: int = 300,
                 lane_width: int | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.maxfev = maxfev  # per-restart budget (nmplus.py:212-215)
        self.lane_width = (self.default_lane_width if lane_width is None
                           else lane_width)

    def initial_simplices(self, x0s: torch.Tensor) -> torch.Tensor:
        """scipy-style init: axis steps of 5% around each start, clipped
        into bounds; x0s (R, d) -> (R, d+1, d)."""
        d = x0s.shape[1]
        steps = torch.where(x0s != 0, 0.05 * x0s, 0.00025)
        simplex0 = torch.cat(
            [x0s[:, None, :],
             x0s[:, None, :] + steps[:, :, None] *
             torch.eye(d, dtype=x0s.dtype, device=x0s.device)[None]], dim=1)
        return torch.clamp(simplex0, self._lower, self._upper)

    def _run_batch(self, x0s, keys) -> BatchResult:
        use_fixed = self.use_fixed_ham
        mul = self.train_size if use_fixed else 1
        infid_b = objectives.make_infidelity_batch(self.spec())
        xs, f, nfev, nit, self.stats = _nm_while_batched(
            self.initial_simplices(x0s), keys[0], infid_b, self._lower,
            self._upper, self.maxfev, lanes=self.lane_width)
        if use_fixed:
            fids = trues = 1.0 - f  # nmplus.py:229-231
        else:
            e, _ = infid_b(xs, prng.fold_in(keys[0], 3))
            fids = 1.0 - e
            trues = objectives.fidelity_batch(self.HH, xs, self.In, self.Out)
        return BatchResult(xs, fids, trues, nfev * mul, nit * mul)
