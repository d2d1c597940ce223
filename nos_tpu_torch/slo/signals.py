"""Per-model scaling signals: a trimmed copy of
``nos_tpu/controllers/autoscaler/signals.py`` (``Signals`` ``:23``,
``SignalRegistry`` ``:34``).

The router (``slo/routing.py``) writes each model's backlog
(``queue_depth``) and last arrival, stamped with the arrival's own time,
so a run on the virtual serving clock stays bit-stable. The reference's
burn-rate and error-budget fields, its ``now_fn`` clock and the
autoscaler that reads them are control plane, not ported yet
(ROADMAP.md, Queue 1 item 17).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class Signals:
    # requests the router accepted but has not given a replica yet
    queue_depth: int = 0
    # the model's last arrival; -inf: none yet
    last_request_t: float = float("-inf")


class SignalRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_model: Dict[str, Signals] = {}

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

    def payload(self) -> Dict[str, dict]:
        """Every model's current signals."""
        with self._lock:
            return {m: {"queue_depth": s.queue_depth, "last_request_t": s.last_request_t}
                    for m, s in sorted(self._by_model.items())}
