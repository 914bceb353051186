"""The optimizer record protocol and top-controller store.

A copy of code_robchar_tpu/utils/record.py (host code, which the port
cannot import from the JAX package: importing any of it pulls in jax),
with program spans (utils/trace.py) on ``offer_many`` and ``save``.

Every optimizer in the reference populates ``self.record`` with the keys
{time_to_get_fid, func_calls, iterations, repeats, best_fid, controller
[, controllers]} (qnewton.py:100, README.md:20 documents this as the porting
contract) and optionally ``self.records`` — function-call-checkpointed
controller sets captured every ``records_update_rate`` calls
(qnewton.py:102-115).  This module centralises that protocol so the five
model families share one implementation instead of the reference's five
copies of ``save_controller_data_aux``.

``TopControllers.offer_many`` offers a whole batch (PPO offers an epoch's
512,000 pairs at once) without replaying every pair through ``offer``.  It
is exact: the store ends with the keys, the first-stored key objects
(``-0.0`` against ``0.0``), the controllers and the insertion order that
the pair-by-pair loop gives.  The argument, under ``offer``'s rules (when
full, evict the minimum, then insert unconditionally; an equal key
overwrites in place):

- Once the store holds ``capacity - 1`` entries it never holds fewer.
  Call its *floor* the least key that an offer leaves in it: the second
  least key of a full store, the least of one with ``capacity - 1``
  entries (none: +inf).  An offer whose key ``f`` lies strictly below the
  floor leaves the store full with ``f`` its strict minimum, so the next
  offer ``g`` pops ``f``.  Without ``f``, ``g``'s offer pops the same
  least key of a full store that ``f``'s did, or finds room in one of
  ``capacity - 1`` entries, and the store after ``g`` is the same dict,
  whatever ``g`` is: new, equal to a stored key, equal to the popped key
  or equal to ``f``.  So ``f`` can be dropped, if another offer follows:
  the batch's last offer is always kept.
- An offer taken with a key at or above a floor ``m`` leaves every key but
  a full store's least at or above ``m``, so the floor never falls below
  a reading of it while only such offers are taken.  One reading at the
  start of a chunk and one vectorised comparison with it find offers of
  the chunk that may be dropped.  (The floor of a full store is its second
  least key because the store keeps its newest offer even when that is
  the worst: its minimum is often a fresh low offer.)
- NaN compares false with everything, and a store holding one has no
  order to rely on: a batch with a NaN key, or offered to a store holding
  one, is replayed whole.

Two counters watch the filter: ``offered`` (pairs handed to
``offer_many``) and ``replayed`` (pairs it passed to ``offer``).
"""

from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from code_robchar_tpu_torch.utils import trace

#: ``offer_many``'s first chunk; each later chunk is twice the one before
FIRST_CHUNK = 1024


class TopControllers:
    """Fidelity-keyed top-c controller store.

    Mirrors the reference's ``running_controllers`` dict semantics
    (qnewton.py:604-616): keyed by fidelity (so equal fidelities collide and
    overwrite — preserved deliberately for parity with shipped .le files
    which were produced that way), evicting the minimum-fidelity entry once
    ``capacity`` is reached.

    ``offered`` and ``replayed`` count the pairs ``offer_many`` was given
    and the pairs it passed on to ``offer`` (module docstring).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._store: Dict[float, List[float]] = {}
        self.offered = 0
        self.replayed = 0

    def offer(self, fid: float, controller: List[float]) -> None:
        if len(self._store) < self.capacity:
            self._store[fid] = controller
        else:
            # reference evicts the min unconditionally, then inserts
            # (qnewton.py:611-613) — even if the newcomer is worse.
            self._store.pop(min(self._store))
            self._store[fid] = controller

    @trace.spanned("record.offers")
    def offer_many(self, fids, controllers) -> None:
        """Offer the pairs ``zip(fids, controllers)`` in order, with the
        result of offering them one by one (module docstring).

        The batch is walked in chunks of ``FIRST_CHUNK`` pairs, doubling.
        While the store holds fewer than ``capacity - 1`` entries each pair
        is replayed; after that a chunk reads the store's floor once, drops
        the chunk's pairs whose key lies below it, except the batch's last,
        and replays the rest.  A batch with a NaN key, or offered to a
        store holding one, is replayed whole.  ``offered`` grows by the
        batch's pairs, ``replayed`` by those replayed.
        """
        f = np.asarray(fids, dtype=np.float64).reshape(-1)
        n = min(len(f), len(controllers))
        self.offered += n

        def replay(i):
            self.offer(float(f[i]), list(map(float, controllers[i])))

        if np.isnan(f[:n]).any() or any(k != k for k in self._store):
            for i in range(n):
                replay(i)
            self.replayed += n
            return
        i, step = 0, FIRST_CHUNK
        while i < n:
            end = min(n, i + step)
            step *= 2
            while i < end and len(self._store) < self.capacity - 1:
                replay(i)
                self.replayed += 1
                i += 1
            if i == end:
                continue
            keep = i + np.flatnonzero(~(f[i:end] < self._floor()))
            if end == n and (not keep.size or keep[-1] != n - 1):
                keep = np.append(keep, n - 1)
            for k in keep.tolist():
                replay(k)
            self.replayed += keep.size
            i = end

    def _floor(self) -> float:
        """The least key an offer leaves in a store of at least
        ``capacity - 1`` entries (module docstring)."""
        low = heapq.nsmallest(2, self._store)
        if len(self._store) >= self.capacity:
            low = low[1:]
        return low[0] if low else math.inf

    def controllers(self) -> List[List[float]]:
        return list(self._store.values())

    def best_fid(self) -> Optional[float]:
        return max(self._store) if self._store else None

    def __len__(self) -> int:
        return len(self._store)


@dataclass
class RunRecord:
    """record / records bookkeeping shared by all optimizers."""

    landscape_exploration: bool = False
    records_update_rate: Optional[float] = None
    run_until_completion_its: Optional[float] = None
    start_time: float = field(default_factory=time.time)

    record: Dict = field(default_factory=lambda: {
        "time_to_get_fid": None, "func_calls": None, "iterations": None,
        "repeats": None, "best_fid": None, "controller": None})
    records: Dict = field(default_factory=dict)
    _update_counter: float = 0.0

    @trace.spanned("record.save")
    def save(self, *, func_calls: int, iterations, repeats, controller,
             best_fid: float, top: Optional[TopControllers] = None) -> None:
        """One ``save_controller_data_aux`` equivalent (qnewton.py:571-585)."""
        self.record["time_to_get_fid"] = time.time() - self.start_time
        self.record["func_calls"] = func_calls
        self.record["iterations"] = iterations
        self.record["repeats"] = repeats
        self.record["controller"] = controller
        self.record["best_fid"] = best_fid
        if self.landscape_exploration and top is not None:
            self.record["controllers"] = top.controllers()
            if self.records_update_rate:
                self.checkpoint(func_calls, self.record["controllers"])

    def checkpoint(self, fcalls: int, controllers) -> None:
        """fcall-checkpointed controller sets (qnewton.py:107-115): record a
        snapshot whenever fcalls passes the next update boundary."""
        if fcalls > self._update_counter:
            self.records[fcalls] = controllers
            self._update_counter += self.records_update_rate
