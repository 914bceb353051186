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
live) every round, one host sync each (``stats``).

The reference's in-house accelerated variant (nmplus.py:20-193): the
single-stream ``_nm_while`` with stagnation restarts, ``run_accelerated``
on a regular simplex, the host-side objective ``infidelity``, the
benchmark objectives ``powell`` and ``f`` and the simplex helpers.  Its
loop is a host loop too, one sync an iteration, and each iteration puts
all its candidate points into one objective call (one kernel launch).
"""

from __future__ import annotations

import math

import numpy as np
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


def _nm_while(simplex0, key, infid, lower, upper, maxfev, xatol=1e-4,
              fatol=1e-4, stagnation_restart: bool = False,
              improv_thres: float = 1e-6, max_tries: int = 30):
    """One Nelder-Mead stream from ``simplex0`` (d+1, d), the JAX package's
    ``_nm_while`` (nmplus.py:59-193); ``infid(xs (K, d), keys (K, 2)) ->
    (f (K,), calls (K,))`` is a single-point objective broadcast over
    points (objectives.make_infidelity).  Returns (best_x (d,), best_f,
    nfev, nit, stats), the counts as int32 tensors.

    Each iteration draws as the reference does: ``key, k1..k4 =
    split(key, 5)`` for the reflection, the expansion and the two
    contractions, then ``key, ks = split(key)`` and ``split(ks, d+1)`` for
    the d+1 vertices of the shrink (the best one re-evaluated too), and
    all 4 + (d+1) points go to ``infid`` as one batch.  The shrink's last
    vertex is taken from the simplex before the replacement: under a
    shrink the replacement is the worst point itself, so it is the same
    vertex.  Billed are the evaluations of the sequential algorithm:
    reflect, expand when fr < f_best, one contraction when neither is
    accepted, d on a shrink.

    With ``stagnation_restart`` (nmplus.py:162-170) an iteration whose
    last improvement is below ``improv_thres`` counts as stagnant; after
    ``max_tries`` of them the next stagnant one restarts from a regular
    simplex around a uniform point (``key, kx, ks, ke = split(key, 4)``),
    billing its d+1 evaluations' calls; ``tries`` resets only there.  The
    reference's quirks are kept: ``improv`` starts at 0 and ``prev_best``
    at inf, so the first iteration is stagnant.

    The exit condition (and the restart decision) is read on the host
    once an iteration: ``stats["syncs"]``; ``stats["launches"]`` counts
    the objective calls."""
    d = simplex0.shape[1]
    dev, dt = simplex0.device, simplex0.dtype
    i32 = dict(dtype=torch.int32, device=dev)

    def clip(x):
        return torch.clamp(x, lower, upper)

    k0, key = prng.split(key)
    simplex = simplex0
    fvals, _ = infid(simplex0, prng.split(k0, d + 1))
    nfev = torch.tensor(d + 1, **i32)
    ncall = torch.tensor(d + 1, **i32)
    nit = torch.tensor(0, **i32)
    improv = torch.zeros((), dtype=dt, device=dev)
    tries = torch.tensor(0, **i32)
    prev_best = torch.full((), math.inf, dtype=dt, device=dev)
    stats = {"iterations": 0, "syncs": 0, "launches": 1, "restarts": 0}
    never = torch.zeros((), dtype=torch.bool, device=dev)

    while True:
        spread_f = (fvals - fvals[0]).abs().max()
        spread_x = (simplex - simplex[0]).abs().max()
        go = (ncall < maxfev) & ((spread_f > fatol) | (spread_x > xatol))
        restart = never
        if stagnation_restart:
            stagnant = improv < improv_thres
            tries = torch.where(stagnant & (tries < max_tries), tries + 1,
                                tries)
            restart = stagnant & (tries >= max_tries)
        go, restart = torch.stack([go, restart]).tolist()
        stats["syncs"] += 1
        if not go:
            break
        if restart:
            key, kx, ks, ke = prng.split(key, 4)
            x0 = lower + (upper - lower) * prng.uniform(kx, (d,), dt).to(dev)
            simplex = regular_simplex(x0, lower, upper, ks)
            fvals, c = infid(simplex, prng.split(ke, d + 1))
            nfev = nfev + c.sum(dtype=torch.int32)
            ncall = ncall + (d + 1)
            tries = torch.zeros_like(tries)
            stats["launches"] += 1
            stats["restarts"] += 1

        order = torch.argsort(fvals, stable=True)
        simplex = simplex[order]
        fvals = fvals[order]
        centroid = simplex[:-1].mean(0)
        worst = simplex[-1]

        key, k1, k2, k3, k4 = prng.split(key, 5).unbind(-2)
        xr = clip(centroid + _ALPHA * (centroid - worst))
        xe = clip(centroid + _GAMMA * (xr - centroid))
        xc_out = clip(centroid + _RHO * (xr - centroid))
        xc_in = clip(centroid - _RHO * (centroid - worst))
        key, ks = prng.split(key).unbind(-2)
        shrunk = simplex[0] + _SIGMA * (simplex - simplex[0])
        fs, _ = infid(torch.cat([torch.stack([xr, xe, xc_out, xc_in]),
                                 shrunk]),
                      torch.cat([torch.stack([k1, k2, k3, k4]),
                                 prng.split(ks, d + 1)]))
        stats["launches"] += 1
        fr, fe, fc_out, fc_in = fs[0], fs[1], fs[2], fs[3]
        f_shrunk = fs[4:]

        f_best, f_second_worst, f_worst = fvals[0], fvals[-2], fvals[-1]
        use_expand = (fr < f_best) & (fe < fr)
        use_reflect = (fr < f_second_worst) & ~use_expand
        use_contract_out = (~use_expand & ~use_reflect &
                            (fr < f_worst) & (fc_out <= fr))
        use_contract_in = (~use_expand & ~use_reflect & (fr >= f_worst) &
                           (fc_in < f_worst))
        shrink = ~(use_expand | use_reflect | use_contract_out |
                   use_contract_in)

        new_point = torch.where(
            use_expand, xe, torch.where(
                use_reflect, xr, torch.where(
                    use_contract_out, xc_out, torch.where(
                        use_contract_in, xc_in, worst))))
        new_f = torch.where(
            use_expand, fe, torch.where(
                use_reflect, fr, torch.where(
                    use_contract_out, fc_out, torch.where(
                        use_contract_in, fc_in, f_worst))))
        simplex = torch.where(shrink, shrunk,
                              torch.cat([simplex[:-1], new_point[None]]))
        fvals = torch.where(shrink, f_shrunk,
                            torch.cat([fvals[:-1], new_f[None]]))

        seq_evals = (1 + (fr < f_best).to(torch.int32)
                     + (~use_expand & ~use_reflect).to(torch.int32)
                     + shrink.to(torch.int32) * d)
        nfev = nfev + seq_evals
        ncall = ncall + seq_evals
        nit = nit + 1
        best = fvals.min()
        improv = torch.where(torch.isinf(prev_best), best, prev_best - best)
        prev_best = best
        stats["iterations"] += 1

    i = torch.argsort(fvals, stable=True)[0]
    return simplex[i], fvals[i], nfev, nit, stats


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

    # --------- the reference's in-house accelerated variant -------------

    def infidelity(self, x) -> float:
        """Host-side objective (nmplus.py:48-52): one controller's
        infidelity under the run's noise, one or two ``next_key()``."""
        if self.use_fixed_ham:
            return 1 - self.fidelity_ss_av(x)
        return 1 - self.fidelity_ss(x, noisy=self.fid_noisy,
                                    ham_noisy=self.ham_noisy)

    @staticmethod
    def powell(x) -> float:
        """Benchmark objective 1 (nmplus.py:54-60)."""
        x = np.asarray(x, dtype=float)
        return (((x[:-1] + x[1:]) ** 2).sum() +
                (5 * (x[2:-1] - x[3:]) ** 2).sum() +
                ((x[1:-1] - 2 * x[2:]) ** 4).sum() +
                (10 * (x[:-3] - x[3:]) ** 4).sum())

    @staticmethod
    def f(x) -> float:
        """Benchmark objective 2 (nmplus.py:61-64)."""
        return math.sin(x[0]) * math.cos(x[1]) * (1.0 / (abs(x[2]) + 2))

    def sort_simplex(self, simplex, obj_f=None):
        """The vertices sorted by objective value and the sorted values
        (nmplus.py:66-73); ``obj_f`` defaults to ``infidelity``."""
        obj_f = obj_f or self.infidelity
        simplex = np.asarray(simplex)
        vals = [float(obj_f(v)) for v in simplex]
        return simplex[np.argsort(vals)], sorted(vals)

    def estimate_hyperplane(self, sorted_simplex, infidelities):
        """Least-squares hyperplane coefficients through the simplex
        (nmplus.py:76-84), the planar-reflection direction of the
        accelerated variant (flagged broken upstream, nmplus.py:327-331),
        solved with lstsq as the JAX package does."""
        s = np.asarray(sorted_simplex, dtype=float)
        x = np.ones((s.shape[0], s.shape[1] + 1))
        x[:, 1:] = s
        g, *_ = np.linalg.lstsq(x, np.asarray(infidelities, float),
                                rcond=None)
        return g[1:]

    def run_accelerated(self, iterations: int, simplex=None):
        """The reference's in-house ``_run`` (nmplus.py:152-189): one
        regular-simplex NM stream with stagnation restarts on the
        single-point objective, ``iterations`` objective calls at most;
        returns (best_infidelity, best_point).  One ``next_key()`` seeds
        both the regular simplex and the loop, as in the JAX package.
        ``stats`` holds the loop's iterations, syncs, launches and
        restarts."""
        infid = objectives.make_infidelity(self.spec())
        key = self.next_key()
        if simplex is None:
            x0 = torch.as_tensor(self.init_points(1)[0], dtype=self.dtype,
                                 device=self.device)
            simplex = regular_simplex(x0, self._lower, self._upper, key)
        simplex = torch.as_tensor(simplex, dtype=self.dtype,
                                  device=self.device)
        x, f, nfev, nit, self.stats = _nm_while(
            simplex, key, infid, self._lower, self._upper, maxfev=iterations,
            stagnation_restart=True)
        return float(f), x.cpu().numpy()
