"""Structure sizes: counterpart of ``nos_tpu/timeline/sizes.py``.

Every bounded but growable structure (the planner's memos, the trace
ring, the watch queues) registers a zero-argument size callback under a
stable name; the ``TimelineStore`` samples them into ``size.*`` series,
which the leak detector watches. Registration is replace-by-name, so a
rebuilt structure re-points its name instead of leaving a dead callback;
a callback that raises is skipped for that sample.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List


class SizeRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], int]] = {}

    def register(self, name: str, size_fn: Callable[[], int]) -> None:
        """Register (or re-point) the size callback of ``name``."""
        with self._lock:
            self._sources[name] = size_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def sizes(self) -> Dict[str, float]:
        """name → its current size, by name; failing callbacks skipped."""
        with self._lock:
            sources = dict(self._sources)
        out: Dict[str, float] = {}
        for name in sorted(sources):
            try:
                out[name] = float(sources[name]())
            except Exception:
                continue
        return out


# the process-wide size registry of the port
SIZES = SizeRegistry()
