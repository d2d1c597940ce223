"""The reporter / actuator handshake: counterpart of
``nos_tpu/controllers/tpuagent/shared.py:9`` (reference
internal/controllers/migagent/shared.go:24-57). The actuator acts only
after the reporter has read the devices since its last apply, so it
always diffs against fresh device state. Both read the node's spec
geometry through ``spec_geometries``, parsed once per stored node."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from nos_tpu_torch.gpu import annotations as annot


class SharedState:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reported_since_last_apply = False
        self.last_applied_plan_id = ""
        self._apply_listeners: List[Callable[[str], None]] = []
        self._spec_memo: Optional[tuple] = None  # (node object, its spec geometry)

    def add_apply_listener(self, fn: Callable[[str], None]) -> None:
        """``fn(plan_id)`` runs after every apply: the agent reports at
        once, so a plan's ack never waits out the report interval (an
        apply clamped to nothing changes no device and starts nothing
        else)."""
        self._apply_listeners.append(fn)

    def spec_geometries(self, node) -> Dict[int, Dict[str, int]]:
        """The node's spec geometry per GPU, parsed once per stored node
        object (the store replaces it on every write)."""
        memo = self._spec_memo
        if memo is None or memo[0] is not node:
            spec, _ = annot.parse_node_annotations(node.annotations)
            memo = self._spec_memo = (node, annot.spec_geometries(spec))
        return memo[1]

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
