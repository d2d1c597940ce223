"""Per-model scaling signals, bridged from the data plane.

Counterpart of ``nos_tpu/controllers/autoscaler/signals.py:18-79``
(``Signals``, ``SignalRegistry``). The SLO engine and the router run on
their own clocks (the virtual serving clock in the benches), so the
registry takes a ``now_fn`` and the reconciler reads every time through
it: no wall-clock value reaches a decision or a status field, and a run
on virtual time stays bit-stable.

Writers: the SLO evaluation (``burn_fast`` / ``burn_slow`` /
``error_budget_remaining``) and the router (``slo/routing.py``:
``queue_depth`` and ``last_request_t``, stamped with the arrival's own
time). Reader: the ModelServing reconciler, through ``get(model)``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List


@dataclass(frozen=True)
class Signals:
    # the highest burn rate over the model's SLOs in each window; the
    # least error budget left
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    error_budget_remaining: float = 1.0
    # requests the router accepted but has not given a replica yet
    queue_depth: int = 0
    # the model's last arrival; -inf: none yet
    last_request_t: float = float("-inf")


class SignalRegistry:
    def __init__(self, now_fn: Callable[[], float] = time.time) -> None:
        self.now_fn = now_fn
        self._lock = threading.Lock()
        self._by_model: Dict[str, Signals] = {}

    def now(self) -> float:
        return self.now_fn()

    def get(self, model: str) -> Signals:
        with self._lock:
            return self._by_model.get(model, Signals())

    def update(self, model: str, **fields) -> Signals:
        """Replace the named fields of the model's signals at once."""
        with self._lock:
            sig = replace(self._by_model.get(model, Signals()), **fields)
            self._by_model[model] = sig
            return sig

    def note_arrival(self, model: str, t: float, queue_depth: int) -> None:
        with self._lock:
            sig = self._by_model.get(model, Signals())
            self._by_model[model] = replace(
                sig, last_request_t=max(sig.last_request_t, t), queue_depth=queue_depth)

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._by_model)

    def payload(self) -> Dict[str, dict]:
        """Every model's current signals."""
        with self._lock:
            return {m: {"burn_fast": s.burn_fast, "burn_slow": s.burn_slow,
                        "error_budget_remaining": s.error_budget_remaining,
                        "queue_depth": s.queue_depth, "last_request_t": s.last_request_t}
                    for m, s in sorted(self._by_model.items())}
