"""Loop health: busy meters and the loops' stats document.

Counterpart of ``nos_tpu/util/loop_health.py``. Every control loop has
one shape, block for work, do it, repeat, and one failure mode under
saturation: its busy fraction pins at 1.0 while its watch queue's drain
lag grows. ``BusyMeter`` gives each loop a windowed busy fraction (the
``nos_tpu_controller_busy_fraction`` gauge); ``LOOPS``, a process-wide
``LoopHealthRegistry``, holds each running loop's stats callback, and
``payload(store)`` answers "which loop is behind and by how much" in one
document: each loop's stats, the store's watch depths and the saturation
series of the metrics registry.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from nos_tpu_torch.util import metrics


class BusyMeter:
    """A loop reports each iteration's busy and idle seconds; once a
    window's total crosses ``WINDOW_SECONDS`` the gauge takes the
    window's busy share and the window starts again."""

    WINDOW_SECONDS = 1.0

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._window_busy = 0.0
        self._window_total = 0.0
        self._busy_total = 0.0
        self._iterations = 0
        self._fraction = 0.0
        self._gauge = metrics.CONTROLLER_BUSY.labels(loop=name)

    def record(self, busy_s: float, idle_s: float = 0.0) -> None:
        with self._lock:
            self._window_busy += busy_s
            self._window_total += busy_s + idle_s
            self._busy_total += busy_s
            if busy_s > 0:
                self._iterations += 1
            if self._window_total >= self.WINDOW_SECONDS:
                self._fraction = self._window_busy / self._window_total
                self._gauge.set(round(self._fraction, 4))
                self._window_busy = 0.0
                self._window_total = 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"busy_fraction": round(self._fraction, 4),
                    "busy_seconds_total": round(self._busy_total, 4),
                    "iterations": self._iterations}


SATURATION_PREFIXES = ("nos_tpu_controller_busy_fraction", "nos_tpu_watch_drain_lag_seconds",
                       "nos_tpu_watch_queue_depth", "nos_tpu_store_lock_")


class LoopHealthRegistry:
    """Live loop-stats callbacks: a loop registers on start and
    unregisters on stop."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loops: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def register(self, name: str, stats_fn: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            self._loops[name] = stats_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._loops.pop(name, None)

    def names(self) -> list:
        with self._lock:
            return sorted(self._loops)

    def payload(self, store: Optional[Any] = None) -> Dict[str, Any]:
        with self._lock:
            loops = dict(self._loops)
        doc: Dict[str, Any] = {"generated_monotonic": time.monotonic(), "loops": {}}
        for name, stats_fn in sorted(loops.items()):
            try:
                doc["loops"][name] = stats_fn()
            except Exception as exc:  # noqa: BLE001 - one loop's fault stays its own
                doc["loops"][name] = {"error": f"{type(exc).__name__}: {exc}"}
        if store is not None and hasattr(store, "watch_stats"):
            doc["watchers"] = store.watch_stats()
        doc["metrics"] = {key: value for key, value in metrics.REGISTRY.snapshot().items()
                          if key.startswith(SATURATION_PREFIXES)}
        return doc


# the process-wide loop registry
LOOPS = LoopHealthRegistry()
