"""The reporter / actuator handshake: counterpart of
``nos_tpu/controllers/tpuagent/shared.py:9`` (reference
internal/controllers/migagent/shared.go:24-57). The actuator acts only
after the reporter has read the devices since its last apply, so it
always diffs against fresh device state."""
from __future__ import annotations

import threading
from typing import Callable, List


class SharedState:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reported_since_last_apply = False
        self.last_applied_plan_id = ""
        self._apply_listeners: List[Callable[[str], None]] = []

    def add_apply_listener(self, fn: Callable[[str], None]) -> None:
        """``fn(plan_id)`` runs after every apply: the agent reports at
        once, so a plan's ack never waits out the report interval (an
        apply clamped to nothing changes no device and starts nothing
        else)."""
        self._apply_listeners.append(fn)

    def on_report(self) -> None:
        with self._lock:
            self._reported_since_last_apply = True

    def on_apply(self, plan_id: str) -> None:
        with self._lock:
            self._reported_since_last_apply = False
            self.last_applied_plan_id = plan_id
        for fn in list(self._apply_listeners):
            fn(plan_id)

    def at_least_one_report_since_last_apply(self) -> bool:
        with self._lock:
            return self._reported_since_last_apply
