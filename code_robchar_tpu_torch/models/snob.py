"""SNOB: budget-matched stable-noise global search, SNOBFIT-class
(counterpart of code_robchar_tpu/models/snob.py).

Reference: the SNOB subclass (qnewton.py:770-928) delegates to
skquant/SQSnobFit's SNOBFIT with a 300-eval budget per restart.  The JAX
package's stand-in, ported here, keeps SNOBFIT's structure with the same
budget accounting (300 objective evals per restart, billed x train_size
under fixed-ham, qnewton.py:862-866).  Round r evaluates q = 10
candidates per restart:

- 1 model point: a trust-radius step against a linear least-squares
  gradient fitted to the previous round's scattered evaluations;
- 2 Gaussian jitters around the incumbent;
- 7 exploration points uniform in the box.

Restarts are ranked by SNOBFIT's reported optimum 1 - optval, the min over
the noisy evaluation history (qnewton.py:836-838).

All restarts advance together: the JAX package's ``fori_loop`` of rounds
is a host loop here, each round one lanes batch of K x 10 controllers
through ``objectives.make_infidelity_batch`` (the amplitude kernel on the
card).  The loop has no data-dependent exit, so it never waits on the
card; its key chain stays on the batch's device.  The normal equations are
solved with ``torch.linalg.solve_ex`` and its status is not read: like
``jnp.linalg.solve``, a singular system passes its non-finite result on
instead of raising (and checking it would cost a host sync a round).
"""

from __future__ import annotations

import torch

from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.models.base import BatchResult, ControlOptimizer
from code_robchar_tpu_torch.ops import prng

_N_JIT = 2       # Gaussian jitter candidates per round
_N_EXP = 7       # uniform exploration candidates per round
_Q = 1 + _N_JIT + _N_EXP
_SHRINK = 0.96   # trust-radius shrink on a failed round
_GROW = 1.03     # growth on success
_R0 = 0.28       # initial trust radius (fraction of the box span)


def _round(carry, infid_b, lower, upper, eye):
    """One round of all restarts (the reference's ``round_body``): carry
    (best_x, best_f, radius, nfev, key, mem_x, mem_f) -> the same after
    the round's K x 10 candidates, one ``infid_b`` batch."""
    best_x, best_f, radius, nfev, key, mem_x, mem_f = carry
    k, d = best_x.shape
    span = upper - lower
    key, kg, ku, kc = prng.split(key, 4)

    # model point: linear least-squares gradient of the previous round's
    # scattered evaluations, through the normal equations with a small
    # Tikhonov term
    dx = mem_x - best_x[:, None, :]
    df = mem_f - best_f[:, None]
    ata = torch.einsum("kqa,kqb->kab", dx, dx) + 1e-9 * eye[None]
    atb = torch.einsum("kqa,kq->ka", dx, df)
    g = torch.linalg.solve_ex(ata, atb[..., None]).result[..., 0]
    gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-12
    model_pt = best_x - radius * g / gn

    jit = best_x[:, None, :] + radius[:, None, :] * prng.normal(
        kg, (k, _N_JIT, d), best_x.dtype)
    exp = lower + span * prng.uniform(ku, (k, _N_EXP, d), best_x.dtype)
    cands = torch.clamp(torch.cat([model_pt[:, None, :], jit, exp], dim=1),
                        lower, upper)
    fs, cs = infid_b(cands.reshape(k * _Q, d), kc)
    fs = fs.reshape(k, _Q)
    nfev = nfev + cs.reshape(k, _Q).sum(1).to(torch.int32)

    i = torch.argmin(fs, dim=1)
    fi = torch.take_along_dim(fs, i[:, None], dim=1)[:, 0]
    xi = torch.take_along_dim(cands, i[:, None, None], dim=1)[:, 0]
    improved = fi < best_f
    best_x = torch.where(improved[:, None], xi, best_x)
    best_f = torch.where(improved, fi, best_f)
    radius = torch.where(improved[:, None],
                         torch.minimum(radius * _GROW, span),
                         torch.maximum(radius * _SHRINK, 1e-6 * span))
    return best_x, best_f, radius, nfev, key, cands, fs


def _snob_restarts_batched(x0s, key, infid_b, lower, upper, budget):
    """All restarts of x0s (K, d) advance together, ``budget // 10``
    rounds of ``_round``; every round's K x 10 candidates are one
    ``infid_b(xs, key) -> (f, calls)`` batch.  Returns (best_x (K, d),
    best_f (K,), nfev (K,))."""
    k, d = x0s.shape
    eye = torch.eye(d, dtype=x0s.dtype, device=x0s.device)

    key = key.to(x0s.device)
    key, k0 = prng.split(key)
    f0, c0 = infid_b(x0s, k0)
    carry = (x0s, f0, (_R0 * (upper - lower)).expand(k, d),
             c0.to(torch.int32), key, x0s[:, None, :].expand(k, _Q, d),
             f0[:, None].expand(k, _Q))
    for _ in range(budget // _Q):
        carry = _round(carry, infid_b, lower, upper, eye)
    return carry[0], carry[1], carry[3]


class SNOB(ControlOptimizer):
    name = "snob"
    budget_per_restart = 300

    def __init__(self, *args, budget: int = 300, **kwargs):
        super().__init__(*args, **kwargs)
        self.budget = budget  # qnewton.py:818-821: 300 either way

    def _run_batch(self, x0s, keys) -> BatchResult:
        use_fixed = self.use_fixed_ham
        mul_fac = self.train_size if use_fixed else 1
        infid_b = objectives.make_infidelity_batch(self.spec())
        k = x0s.shape[0]
        xs, f, nfev = _snob_restarts_batched(x0s, keys[0], infid_b,
                                             self._lower, self._upper,
                                             self.budget)
        self.stats = {"rounds": self.budget // _Q, "syncs": 0}
        if use_fixed:
            fids = trues = 1.0 - f  # qnewton.py:842-844
        else:
            # rank by SNOBFIT's reported optimum, the min over the noisy
            # history (qnewton.py:836-838); the true fidelity is the clean
            # recompute (qnewton.py:845-848)
            fids = 1.0 - f
            trues = objectives.fidelity_batch(self.HH, xs, self.In, self.Out)
        # reference accounting: funccalls += budget (x train_size under
        # fixed-ham) whatever the solver evaluated (qnewton.py:862-866);
        # the adaptive protocol bills its in-band counts
        billed = nfev if self.adaptive else torch.full(
            (k,), self.budget * mul_fac, dtype=torch.int32,
            device=x0s.device)
        return BatchResult(xs, fids, trues, billed,
                           torch.zeros(k, dtype=torch.int32,
                                       device=x0s.device))
