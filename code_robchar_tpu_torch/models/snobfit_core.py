"""Vendored SNOBFIT (a copy of code_robchar_tpu/models/snobfit_core.py:
framework-free host code, which the port cannot import from the JAX
package; importing any of it pulls in jax).

Branch-and-fit global optimization for noisy
objectives, written from the published algorithm description (W. Huyer &
A. Neumaier, "SNOBFIT — Stable Noisy Optimization by Branch and Fit",
ACM TOMS 35(2), 2008) — NOT a copy of SQSnobFit (whose source the repo
does not hold; artifacts/figparity/skquant_install_attempt.log).

Why this exists: the reference's SNOB optimizer calls
``skquant.opt.minimize(method="snobfit")`` (qnewton.py:818-835), and
neither skquant nor SQSnobFit is a dependency of this repo.
``models.snob.SNOB`` is the production budget-matched surrogate; THIS
module provides an executing implementation of the actual branch-and-fit
algorithm so the exact-path adapter (models/snob_skquant.py) runs for
real: each restart maintains a box branching of the search domain,
local linear fits around evaluated points, a quadratic fit around the
incumbent, and proposes batches of points from the paper's five classes.

Algorithm summary (paper §2-§4):

- every evaluated point x_j owns a box [l_j, u_j] of the domain; when a
  new point lands in an existing box, the box is split along the
  coordinate with the largest scaled distance between owner and
  newcomer, at the golden-section point, with the larger share going to
  the point with the lower f (so good regions keep room to refine);
- class 1: minimizer of a safeguarded quadratic fit around the best
  point, inside a trust box spanned by the fit's neighbor radius;
- class 2: for "local" points (better than all their nearest
  neighbors), a descent step from the local linear fit, inside an
  inflated own-box trust region;
- class 3: for further good points, the linear-fit descent corner of
  the point's OWN box (local refinement);
- class 4: exploration — split the largest (smallest-smallness) boxes
  at the midpoint of the longer segment of their longest side;
- class 5: uniform random space-fillers when the other classes cannot
  produce enough separated points.

The skquant-compatible surface at the bottom (``minimize``/``optset``)
mirrors the call the reference makes, so ``snob_skquant.SNOBSkquant``
drives this implementation unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_GOLD = 0.5 * (np.sqrt(5.0) - 1.0)          # 0.618...


class SnobFit:
    """Branch-and-fit state over a box domain.

    Parameters
    ----------
    bounds : (n, 2) array — search box [u, v] per coordinate.
    dx : optional (n,) resolution vector (minimal meaningful step);
        defaults to 1e-5 * (v - u) as in the paper's recommendation.
    maxmp : cap on the number of points entering any local/quadratic
        fit (skquant's ``maxmp`` option; reference sets 150).
    rng : numpy Generator for class-5 fillers and tie-breaks.
    """

    def __init__(self, bounds, dx=None, maxmp: int = 150, rng=None):
        bounds = np.asarray(bounds, dtype=float)
        self.u = bounds[:, 0].copy()
        self.v = bounds[:, 1].copy()
        self.n = len(self.u)
        self.span = np.where(self.v > self.u, self.v - self.u, 1.0)
        self.dx = (np.asarray(dx, dtype=float) if dx is not None
                   else 1e-5 * self.span)
        self.maxmp = int(maxmp)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.x: List[np.ndarray] = []        # evaluated points
        self.f: List[float] = []
        self.lo: List[np.ndarray] = []       # per-point box walls
        self.hi: List[np.ndarray] = []

    # ------------------------------------------------------------- state

    @property
    def m(self) -> int:
        return len(self.x)

    def best(self) -> Tuple[np.ndarray, float]:
        j = int(np.argmin(self.f))
        return self.x[j], self.f[j]

    def _scaled(self, x) -> np.ndarray:
        return (np.asarray(x) - self.u) / self.span

    def _smallness(self, j: int) -> float:
        """-sum_i log2 of the box's scaled side lengths: higher = box
        has been split more = smaller (paper §2)."""
        side = (self.hi[j] - self.lo[j]) / self.span
        side = np.maximum(side, 1e-300)
        return float(np.round(-np.sum(np.log2(side))))

    # -------------------------------------------------------------- tell

    def tell(self, x, fx: float) -> None:
        """Insert an evaluated point, branching the box it lands in."""
        x = np.clip(np.asarray(x, dtype=float), self.u, self.v)
        if self.m == 0:
            self.x.append(x)
            self.f.append(float(fx))
            self.lo.append(self.u.copy())
            self.hi.append(self.v.copy())
            return
        # owner = the point whose box contains x (ties -> nearest owner)
        owners = [j for j in range(self.m)
                  if np.all(x >= self.lo[j]) and np.all(x <= self.hi[j])]
        if not owners:                        # numeric edge: nearest box
            d = [np.linalg.norm(self._scaled(x) - self._scaled(self.x[j]))
                 for j in range(self.m)]
            owners = [int(np.argmin(d))]
        k = min(owners, key=lambda j: np.linalg.norm(
            self._scaled(x) - self._scaled(self.x[j])))

        xl, xh = self.lo[k].copy(), self.hi[k].copy()
        xo = self.x[k]
        diff = np.abs(x - xo) / self.span
        if np.all(diff < self.dx / self.span):
            # duplicate at resolution: keep the better f, no branching
            if fx < self.f[k]:
                self.x[k], self.f[k] = x, float(fx)
            return
        i = int(np.argmax(diff))
        # golden-section split between owner and newcomer; larger share
        # to the point with smaller f (paper §2)
        a, b = xo[i], x[i]
        lam = _GOLD if fx < self.f[k] else (1.0 - _GOLD)
        z = a + lam * (b - a)
        new_lo, new_hi = xl.copy(), xh.copy()
        if b > a:
            self.hi[k] = self.hi[k].copy()
            self.hi[k][i] = z                 # owner keeps lower part
            new_lo[i] = z
        else:
            self.lo[k] = self.lo[k].copy()
            self.lo[k][i] = z                 # owner keeps upper part
            new_hi[i] = z
        self.x.append(x)
        self.f.append(float(fx))
        self.lo.append(new_lo)
        self.hi.append(new_hi)

    # -------------------------------------------------------------- fits

    def _neighbors(self, j: int, k: int) -> np.ndarray:
        """Indices of the k nearest (scaled) neighbors of point j."""
        xs = self._scaled(np.asarray(self.x))
        d = np.linalg.norm(xs - xs[j], axis=1)
        d[j] = np.inf
        order = np.argsort(d)
        return order[:min(k, self.m - 1)]

    def _linear_fit(self, j: int) -> Optional[np.ndarray]:
        """Weighted least-squares gradient of a local linear model at
        point j from its n+2 nearest neighbors (paper §3)."""
        if self.m < self.n + 2:
            return None
        nb = self._neighbors(j, min(self.n + 2, self.maxmp))
        a = (np.asarray([self.x[i] for i in nb]) - self.x[j]) / self.span
        b = np.asarray([self.f[i] for i in nb]) - self.f[j]
        w = 1.0 / np.maximum(np.linalg.norm(a, axis=1), 1e-12)
        g, *_ = np.linalg.lstsq(a * w[:, None], b * w, rcond=None)
        return g / self.span                  # gradient in raw coords

    def _quadratic_step(self) -> Optional[np.ndarray]:
        """Class 1: minimize a safeguarded full quadratic fit around
        the incumbent, inside the trust box spanned by the fit points
        (paper §4)."""
        need = self.n + 2
        if self.m < need + 1:
            return None
        jb = int(np.argmin(self.f))
        k = min(self.m - 1, max(self.n * (self.n + 3) // 2 + 2, need),
                self.maxmp)
        nb = self._neighbors(jb, k)
        d = (np.asarray([self.x[i] for i in nb]) - self.x[jb]) / self.span
        b = np.asarray([self.f[i] for i in nb]) - self.f[jb]
        # design: [d, 0.5 * upper-tri products]; fall back to linear-only
        # when too few points for the quadratic block
        iu = np.triu_indices(self.n)
        quad_ok = len(nb) >= self.n + len(iu[0])
        if quad_ok:
            cross = 0.5 * d[:, iu[0]] * d[:, iu[1]] * \
                (2.0 - (iu[0] == iu[1]).astype(float))
            design = np.concatenate([d, cross], axis=1)
        else:
            design = d
        w = 1.0 / (1.0 + np.linalg.norm(d, axis=1))
        coef, *_ = np.linalg.lstsq(design * w[:, None], b * w, rcond=None)
        g = coef[:self.n]
        h = np.zeros((self.n, self.n))
        if quad_ok:
            h[iu] = coef[self.n:]
            h = 0.5 * (h + h.T)
        # trust box: the radius actually covered by the fit points
        rho = np.maximum(np.max(np.abs(d), axis=0), self.dx / self.span)
        lo = np.maximum(-rho, (self.u - self.x[jb]) / self.span)
        hi = np.minimum(rho, (self.v - self.x[jb]) / self.span)
        step = _box_quadratic_min(g, h, lo, hi)
        return self.x[jb] + step * self.span

    # ----------------------------------------------------------- suggest

    def suggest(self, nreq: int) -> np.ndarray:
        """Propose ``nreq`` evaluation points from the five classes."""
        out: List[np.ndarray] = []

        def push(y) -> bool:
            y = np.clip(np.asarray(y, dtype=float), self.u, self.v)
            for z in (self.x + out):
                if np.all(np.abs(y - z) < self.dx):
                    return False
            out.append(y)
            return True

        if self.m == 0:
            # cold start: center + random
            push(0.5 * (self.u + self.v))
            while len(out) < nreq:
                push(self.u + self.span *
                     self.rng.uniform(size=self.n))
            return np.asarray(out[:nreq])

        # class 1: quadratic model around the incumbent
        y = self._quadratic_step()
        if y is not None:
            push(y)

        # classes 2+3: linear-fit descent for the best points — class 2
        # uses an inflated trust region around "local" points, class 3
        # the point's own box
        order = np.argsort(self.f)
        budget23 = max(1, (nreq - len(out)) * 2 // 3)
        taken = 0
        for j in order:
            if taken >= budget23 or len(out) >= nreq:
                break
            g = self._linear_fit(int(j))
            if g is None:
                break
            lo, hi = self.lo[j], self.hi[j]
            nb = self._neighbors(int(j), self.n + 2)
            is_local = all(self.f[j] <= self.f[i] for i in nb)
            if is_local:
                # class 2: inflate the own box by the neighbor radius
                rad = np.max(np.abs(
                    np.asarray([self.x[i] for i in nb]) - self.x[j]),
                    axis=0)
                lo = np.maximum(self.u, np.minimum(lo, self.x[j] - rad))
                hi = np.minimum(self.v, np.maximum(hi, self.x[j] + rad))
            # descent corner, pulled to the golden point so repeated
            # suggestions keep branching the box instead of piling on
            # the wall
            corner = np.where(g > 0, lo, hi)
            y = self.x[j] + _GOLD * (corner - self.x[j])
            if push(y):
                taken += 1

        # class 4: split the largest boxes (exploration)
        if len(out) < nreq:
            small = np.asarray([self._smallness(j) for j in range(self.m)])
            for j in np.argsort(small):
                if len(out) >= nreq:
                    break
                side = (self.hi[j] - self.lo[j]) / self.span
                i = int(np.argmax(side))
                up = self.hi[j][i] - self.x[j][i]
                down = self.x[j][i] - self.lo[j][i]
                y = self.x[j].copy()
                y[i] = (0.5 * (self.x[j][i] + self.hi[j][i]) if up >= down
                        else 0.5 * (self.lo[j][i] + self.x[j][i]))
                push(y)

        # class 5: uniform fillers
        guard = 0
        while len(out) < nreq and guard < 100 * nreq:
            push(self.u + self.span * self.rng.uniform(size=self.n))
            guard += 1
        return np.asarray(out[:nreq])


def _box_quadratic_min(g, h, lo, hi, iters: int = 60) -> np.ndarray:
    """Minimize g.s + 0.5 s^T H s over the box [lo, hi] (scaled coords)
    by projected coordinate descent — exact per-coordinate minimizer,
    cycled; cheap and robust for the n <= 16 fits used here."""
    n = len(g)
    s = np.zeros(n)
    for _ in range(iters):
        moved = 0.0
        for i in range(n):
            quad = h[i, i]
            lin = g[i] + h[i] @ s - quad * s[i]
            if quad > 1e-12:
                si = -lin / quad
            else:
                # non-convex/flat direction: descend to the wall
                si = lo[i] if lin > 0 else hi[i]
            si = min(max(si, lo[i]), hi[i])
            moved = max(moved, abs(si - s[i]))
            s[i] = si
        if moved < 1e-12:
            break
    return s


# --------------------------------------------------------------------------
# skquant-compatible surface (mirrors the call at qnewton.py:818-835)
# --------------------------------------------------------------------------

@dataclass
class OptResult:
    optval: float
    optpar: np.ndarray


@dataclass
class _OptSet:
    maxmp: int = 150
    maxfail: int = 100
    verbose: bool = False
    extra: Dict = field(default_factory=dict)


def optset(optin: Optional[Dict] = None, **kw):
    """SQSnobFit.optset equivalent: bundle options from a dict/kwargs."""
    opts = dict(optin or {})
    opts.update(kw)
    known = {k: opts.pop(k) for k in ("maxmp", "maxfail", "verbose")
             if k in opts}
    return _OptSet(extra=opts, **known)


def minimize(objective: Callable[[np.ndarray], float], x0, bounds,
             budget: int = 300, method: str = "snobfit", options=None,
             rng=None, objective_batch=None):
    """skquant.opt.minimize-shaped loop over the vendored SnobFit.

    Evaluates ``x0``, then alternates suggest/evaluate rounds of
    ``n + 6`` points (the paper's recommended request size) until
    ``budget`` objective evaluations are spent or ``maxfail``
    consecutive evaluations bring no improvement.  Returns
    ``(OptResult, history)`` with history rows ``[f, *x]`` like
    skquant's.

    ``objective_batch`` (extension beyond the skquant surface): an
    optional ``(k, n) -> (k,)`` evaluator used to score each suggested
    batch in ONE call — semantically identical to the sequential loop
    (SNOBFIT state only updates via tell(), and a whole batch is
    suggested before any of it is evaluated) but ~10x cheaper when the
    objective is a jitted device kernel dispatched from the host."""
    if method.lower() != "snobfit":
        raise ValueError("vendored backend implements method='snobfit' only")
    opts = options if isinstance(options, _OptSet) else _OptSet()
    bounds = np.asarray(bounds, dtype=float)
    n = bounds.shape[0]
    sf = SnobFit(bounds, maxmp=opts.maxmp,
                 rng=rng or np.random.default_rng())
    history = []
    fails = 0
    fbest = np.inf

    def evaluate(xs) -> np.ndarray:
        xs = np.asarray(xs, dtype=float)
        if objective_batch is not None:
            return np.asarray(objective_batch(xs), dtype=float)
        return np.asarray([float(objective(x)) for x in xs])

    def book(x, fx: float) -> None:
        nonlocal fails, fbest
        history.append(np.concatenate([[fx], np.asarray(x, dtype=float)]))
        if fx < fbest - 1e-12:
            fbest, fails = fx, 0
        else:
            fails += 1

    x0 = np.clip(np.asarray(x0, dtype=float), bounds[:, 0], bounds[:, 1])
    f0 = evaluate(x0[None, :])[0]
    book(x0, f0)
    sf.tell(x0, f0)
    while len(history) < budget and fails < opts.maxfail:
        batch = sf.suggest(min(n + 6, budget - len(history)))
        if objective_batch is not None:
            fs = evaluate(batch)
        for i, y in enumerate(batch):
            if len(history) >= budget or fails >= opts.maxfail:
                break
            # sequential path evaluates lazily so a mid-batch stop
            # spends no extra objective calls (len(history) == calls);
            # the batch path pre-pays the whole batch by construction
            fy = float(fs[i]) if objective_batch is not None \
                else float(objective(y))
            book(y, fy)
            sf.tell(y, fy)
    xb, fb = sf.best()
    return OptResult(optval=fb, optpar=xb), np.asarray(history)
