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
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from code_robchar_tpu_torch.utils import trace


class TopControllers:
    """Fidelity-keyed top-c controller store.

    Mirrors the reference's ``running_controllers`` dict semantics
    (qnewton.py:604-616): keyed by fidelity (so equal fidelities collide and
    overwrite — preserved deliberately for parity with shipped .le files
    which were produced that way), evicting the minimum-fidelity entry once
    ``capacity`` is reached.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._store: Dict[float, List[float]] = {}

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
        for f, c in zip(fids, controllers):
            self.offer(float(f), list(map(float, c)))

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
