"""Batched Adam controller search on the exact analytic gradient
(counterpart of code_robchar_tpu/models/adam.py).

Reference: the Adam subclass (qnewton.py:641-768), a single sequential
stream of Adam updates on ``eval_static_fidelity_gradient`` with Sobol
restarts every 5000 iterations drawn retry-until-pass against a
gradient-norm gate (1e-4 for N > 7, else 1e-2; each failed probe bills one
function call and one iteration, qnewton.py:681-700), beta1 = .9,
beta2 = .999, eta = 0.008 for N > 7 else 0.03, and the reference's
m_hat = m / (1 - beta1), v_hat = v / (1 - beta2) normalisation.  Moments
are not reset on restart.  Only run_until_told_to_stop with landscape
exploration is supported (qnewton.py:647-648).

Many independent streams advance in lockstep: the K streams ride the lane
dimension of one exact-gradient launch a step
(``objectives.make_exact_gradient_batch``, the gradient kernel on the
card) and one ranking fidelity launch (``make_infidelity_batch``, the
amplitude kernel), unbilled as in the reference (qnewton.py:723-727).  A
segment of ``segment_its`` steps is a host loop; the run loop treats each
segment as one batch.  The restart fires before the last step of the
segment that ends on a 5000-update boundary; it is a host loop over the
probe masks that reads its exit condition (any stream still probing) once
a probe round, one host sync each (``stats``).

Restart candidates come from a stream-strided Sobol table: row g, column
sid holds draw g*K + sid of the instance's Sobol stream after the K start
draws (the run loop draws the starts once for persistent streams), so no
two streams share a restart point.  The table is a rolling window over
that stream, refilled on the host at restart boundaries
(``_maybe_refill_table``), so restart points are never reused.  It is
held in the run's dtype, as the JAX package's ``jnp.asarray`` of the
float64 draws is without x64, and candidates are computed in that dtype.

With a ``mesh`` (parallel/mesh.py) a segment splits the streams over
the mesh's entries when their count is a multiple of its size (else it
runs unsharded): each block advances with its columns of the table and
its own first key, as the JAX package's sharded segment does.

Arithmetic followed from the reference's compiled segment, whose
algebraic simplifier (the same for every XLA backend) rewrites a division
by a constant into a product with the constant's reciprocal, taken in the
run's dtype, and folds constant factors together: ``eta * m / (1 -
beta1)`` becomes ``m * c1`` with c1 = eta * (1 / (1 - beta1)), and
``v / (1 - beta2)`` becomes ``v * (1 / (1 - beta2))``; the port computes
the same products (``adam_update``).  XLA:CPU's code generator also
contracts ``beta1 * m + (1 - beta1) * g`` into a fused multiply-add, a
choice of that backend and not of the program: the port rounds the
product and the sum separately.
"""

from __future__ import annotations

import numpy as np
import torch

from code_robchar_tpu_torch.models import objectives
from code_robchar_tpu_torch.models.base import BatchResult, ControlOptimizer
from code_robchar_tpu_torch.ops import prng

_BETA1, _BETA2 = 0.9, 0.999
_RESTART_EVERY = 5000
#: retry-until-pass cap (the reference's ``while True`` would not end if no
#: candidate passed the gate)
_MAX_RETRIES = 64
#: floor on the Sobol restart-table window (rows); the length is sized from
#: the fcall budget in ``_table_rows`` and the window rolls forward on the
#: host (``_maybe_refill_table``)
_TABLE_LEN_MIN = 256
#: memory bound on the window; the rolling refill covers any budget beyond
_TABLE_LEN_MAX = 16384


def _consts(eta: float, dtype: torch.dtype):
    """The two constants of the reference's compiled Adam step in
    ``dtype``: eta / (1 - beta1), as XLA folds ``eta * (m * (1 / (1 -
    beta1)))``, and 1 / (1 - beta2), each constant first rounded to
    ``dtype``."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return (float(npdt(eta) * (npdt(1) / npdt(1 - _BETA1))),
            float(npdt(1) / npdt(1 - _BETA2)))


def adam_update(w, m, v, grads, eta: float):
    """One Adam step of the reference (adam.py:126-130) on (K, d) tensors:
    -> (w, m, v), in the form the reference's compiled program computes:
    w - (m * c1) / (sqrt(v * c2) + 1e-8) with the constants of
    ``_consts``."""
    c1, c2 = _consts(eta, m.dtype)
    m = _BETA1 * m + (1 - _BETA1) * grads
    v = _BETA2 * v + (1 - _BETA2) * grads * grads
    return w - m * c1 / (torch.sqrt(v * c2) + 1e-8), m, v


def top_candidates(fis: torch.Tensor, ws: torch.Tensor, kc: int):
    """The ``kc`` best steps of each stream: fis (S, K) fidelities and ws
    (S, K, d) points of S steps -> (cand_fid (K, kc), cand_x (K, kc, d)).
    Ties keep the earlier step first, as ``jax.lax.top_k`` does (a stable
    descending sort; ``torch.topk`` promises no order)."""
    order = torch.sort(fis.T, dim=1, descending=True, stable=True).indices
    ci = order[:, :kc]
    cand_fid = torch.take_along_dim(fis.T, ci, dim=1)
    cand_x = torch.take_along_dim(ws.transpose(0, 1), ci[:, :, None], dim=1)
    return cand_fid, cand_x


class Adam(ControlOptimizer):
    name = "adam"
    default_batch = 64        # parallel Adam streams
    segment_its = 1000        # iterations a dispatch
    cand_per_segment = 4      # top-c candidates offered per stream/segment
    #: streams persist across segments: the base loop never shrinks the
    #: batch (the reference loops on tot_its alone, qnewton.py:674)
    persistent_streams = True

    def __init__(self, *args, segment_its: int = None, **kwargs):
        super().__init__(*args, **kwargs)
        if segment_its is not None:
            self.segment_its = int(segment_its)
        if self.segment_its <= 0 or _RESTART_EVERY % self.segment_its:
            # restarts fire on segments that end on a 5000-update boundary
            raise ValueError(
                f"segment_its={self.segment_its} must divide the "
                f"reference restart cadence ({_RESTART_EVERY})")
        if not (self.run_until_told_to_stop and self.landscape_exploration):
            raise Exception("alternative functionality isn't available yet.")
        self.eta = 0.008 if self.Nspin > 7 else 0.03
        self.grad_gate = 1e-4 if self.Nspin > 7 else 1e-2
        self._stream = None
        self._table = None
        self._table_base = 0

    # ------------------------------------------------------- the segment

    def _segment(self, w, m, v, ptr, key, restart: bool, table=None):
        """``segment_its`` Adam steps over the streams (the restart before
        the last one when ``restart``, its candidates from the streams'
        columns ``table``, by default the whole table) -> (w, m, v, ptr,
        fis (S, K), ws (S, K, d), probes (K,))."""
        spec = self.spec()
        exact_b = objectives.make_exact_gradient_batch(spec)
        infid_b = objectives.make_infidelity_batch(spec)
        # the noiseless regimes never read the ranking key, and the
        # segment's last key is not returned: no split there
        keyed = bool(spec.ham_noisy or spec.fid_noisy)
        key = key.to(w.device)
        fis, ws = [], []

        def step(w, m, v, key):
            _, grads = exact_b(w)
            w, m, v = adam_update(w, m, v, grads, self.eta)
            kf = None
            if keyed:
                key, kf = prng.split(key)
            fi_errs, _ = infid_b(w, kf)        # ranking eval: not billed
            fis.append(1.0 - fi_errs)
            ws.append(w)
            return w, m, v, key

        probes = torch.zeros(w.shape[0], dtype=torch.int32, device=w.device)
        seg = self.segment_its
        for _ in range(seg - 1 if restart else seg):
            w, m, v, key = step(w, m, v, key)
        if restart:
            w, ptr, probes = self._retry_restart(w, ptr, exact_b, table)
            w, m, v, key = step(w, m, v, key)
        return w, m, v, ptr, torch.stack(fis), torch.stack(ws), probes

    def _retry_restart(self, w, ptr, exact_b, table=None):
        """qnewton.py:681-700 over the streams: each stream draws Sobol
        candidates from its column of ``table`` (by default the whole
        table) until its exact gradient's norm clears the gate, at most
        ``_MAX_RETRIES`` probes; each probe
        bills one fcall and one iteration per stream still probing.  A
        stream that reaches the cap keeps its point.  -> (w, ptr,
        probes (K,))."""
        k = w.shape[0]
        dev = w.device
        sids = torch.arange(k, device=dev)
        ok = torch.zeros(k, dtype=torch.bool, device=dev)
        tries = torch.zeros(k, dtype=torch.int32, device=dev)
        table = self._table if table is None else table
        rows = table.shape[0]
        span = self._upper - self._lower
        while True:
            active = (~ok) & (tries < _MAX_RETRIES)
            self.stats["syncs"] += 1
            if not bool(active.any()):
                break
            self.stats["probe_rounds"] += 1
            u = table[ptr.long() % rows, sids]
            cands = self._lower + span * u
            _, g = exact_b(cands)
            passed = torch.linalg.vector_norm(g, dim=-1) > self.grad_gate
            ok = torch.where(active, passed, ok)
            w = torch.where((active & passed)[:, None], cands, w)
            tries = torch.where(active, tries + 1, tries)
            ptr = torch.where(active, ptr + 1, ptr)
        return w, ptr, tries

    # ------------------------------------------------- the restart table

    def _table_rows(self, k: int) -> int:
        """Sobol restart rows to preallocate for a k-stream run: the
        expected restarts per stream over the fcall budget, doubled for
        retry slack, floored at _TABLE_LEN_MIN and capped at
        _TABLE_LEN_MAX; the rolling refill serves anything past the cap."""
        budget = self.run_until_completion_its or 0
        n_restarts = int(budget) // (_RESTART_EVERY * max(k, 1)) + 1
        want = 2 * n_restarts + _MAX_RETRIES
        rows = _TABLE_LEN_MIN
        while rows < want and rows < _TABLE_LEN_MAX:
            rows *= 2
        return rows

    def _maybe_refill_table(self, k: int) -> None:
        """Roll the Sobol restart window forward before a restart segment
        if any stream's pointer could run off its end.

        Invariant: for every global row g in [_table_base, _table_base +
        L), table[g % L, sid] is draw g*K + sid of the post-start Sobol
        stream.  A restart segment advances a pointer by at most
        _MAX_RETRIES, so refilling whenever max(ptr) + _MAX_RETRIES would
        leave the window makes reading a row twice impossible.  When the
        live window no longer fits under _TABLE_LEN_MAX the laggard
        pointers are lifted (skipping unread draws is allowed; reading one
        twice is not)."""
        ptr = self._stream[4].cpu().numpy()
        L = int(self._table.shape[0])
        base = self._table_base
        hi_need = int(ptr.max()) + _MAX_RETRIES
        if hi_need <= base + L:
            return
        new_base = int(ptr.min())
        new_len = L
        while new_base + new_len < hi_need and new_len < _TABLE_LEN_MAX:
            new_len *= 2
        if new_base + new_len < hi_need:
            new_base = hi_need - new_len
            lifted = np.maximum(ptr, new_base).astype(np.int32)
            self._stream = self._stream[:4] + (
                torch.as_tensor(lifted, device=self.device),)
        old = self._table.cpu().numpy()
        d = old.shape[2]
        new = np.empty((new_len, k, d), dtype=old.dtype)
        keep = np.arange(new_base, base + L)          # rows still valid
        new[keep % new_len] = old[keep % L]
        fresh_g = np.arange(base + L, new_base + new_len)
        if fresh_g.size:
            # every row from base + L on is generated (those a lift skips
            # too), so row labels stay aligned with the Sobol stream; where
            # fresh_g spans more than new_len rows, the last write (the
            # live row) wins
            new[fresh_g % new_len] = self._sobol_stream(
                fresh_g.size * k).reshape(fresh_g.size, k, d)
        self._table = torch.as_tensor(new, device=self.device)
        self._table_base = new_base

    # ---------------------------------------------------------- dispatch

    def _run_batch(self, x0s, keys) -> BatchResult:
        """One segment of ``segment_its`` Adam steps across the streams;
        the probes of a restart tally into nfev and nit."""
        k = x0s.shape[0]
        d = self.Nspin + 1
        if self._stream is None or self._stream[0].shape[0] != k:
            rows = self._table_rows(k)
            self._table = torch.as_tensor(
                self._sobol_stream(rows * k).reshape(rows, k, d),
                dtype=self.dtype, device=self.device)
            self._table_base = 0
            # jax.random.uniform's default float is float64 under x64 and
            # float32 without: the run's dtype in both regimes
            m0 = prng.uniform(self.next_key(), (k, d), self.dtype)
            v0 = prng.uniform(self.next_key(), (k, d), self.dtype)
            zeros = torch.zeros(k, dtype=torch.int32, device=self.device)
            self._stream = (x0s, m0.to(self.device), v0.to(self.device),
                            zeros, zeros.clone())
        self.stats = {"steps": self.segment_its, "probe_rounds": 0,
                      "syncs": 1}
        its_done = int(self._stream[3][0])
        restart_due = (its_done + self.segment_its) % _RESTART_EVERY == 0
        if restart_due:
            # a refill may lift the pointers: unpack the stream after it
            self._maybe_refill_table(k)
        # shard only when the stream count fills the mesh: a smaller stream
        # set runs unsharded (the run loop's sub-mesh remainder contract)
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        if self.mesh is None or k < n_dev or k % n_dev:
            stream, res = self._advance(self._stream, keys, self._table,
                                        restart_due)
        else:
            stream, res = self._advance_sharded(keys, restart_due)
        self._stream = stream
        return res

    def _advance(self, stream, keys, table, restart: bool):
        """One segment of the streams ``stream`` (w, m, v, it, ptr), keyed
        by ``keys[0]``, restarting from the columns ``table`` when
        ``restart`` -> (the advanced stream, BatchResult)."""
        w, m, v, it, ptr = stream
        w, m, v, ptr, fis, ws, probes = self._segment(w, m, v, ptr, keys[0],
                                                      restart, table)
        seg = self.segment_its
        kc = max(1, min(self.cand_per_segment, seg))
        true = objectives.fidelity_batch(self.HH, w, self.In, self.Out)
        cand_fid, cand_x = top_candidates(fis, ws, kc)
        calls = seg + probes
        return (w, m, v, it + seg, ptr), BatchResult(
            w, fis[-1], true, calls, calls.clone(), cand_x=cand_x,
            cand_fid=cand_fid)

    def _advance_sharded(self, keys, restart: bool):
        """``_advance`` with the stream axis split over ``self.mesh``: each
        block advances its streams, with its columns of the table and its
        own first key (a block's ranking draws are keyed by it), on its
        entry's device, as the JAX package's shard_map segment does; the
        outputs are gathered on the mesh's first device."""
        from code_robchar_tpu_torch.parallel import mesh as pmesh
        mesh = self.mesh
        streams = pmesh.shard_leading_tree(mesh, self._stream,
                                           self._stream[0].shape[0])
        tables = pmesh.shard_batch(mesh, self._table, axis=1)
        key_blocks = pmesh.shard_batch(mesh, keys)
        outs = []
        for dev, stream, table, kb in zip(mesh.devices, streams, tables,
                                          key_blocks):
            view = pmesh.on_device(self, dev)
            with pmesh.on(dev):
                outs.append(view._advance(stream, kb, table, restart))
        stream, res = pmesh.gather_tree(mesh, outs)
        return tuple(x.to(self.device) for x in stream), res

    def run(self):
        # Adam is a persistent stream, not independent restarts: the fcall
        # budget ends the run, repeats is irrelevant (qnewton.py:674).
        # Each run() starts fresh streams, moments, pointers and table.
        self.repeats = int(1e18)
        self._stream = None
        self._table = None
        self._table_base = 0
        return super().run()
