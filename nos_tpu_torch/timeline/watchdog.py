"""The wedge watchdog: counterpart of ``nos_tpu/timeline/watchdog.py``.

Every control loop registers here and beats once an iteration (or hands
over a progress counter, ``counter_fn``). The ``TimelineStore`` samples
each loop's counter into a ``loop.<name>`` series; a loop registered
``periodic=True`` (one that ticks on a timer even when idle: the timeline
sampler itself) is stall-checked always, an event-driven one
(``periodic=False``: the controllers' pumps and workers, the partitioner's
batch loop, the pool workers) only when a policy arms its series. A
stalled loop's finding carries the profiler's stacks of its thread.

This module imports nothing of the package at its top: it sits below
``util/profiling.py`` and ``util/tracing.py``, which register with the
timeline.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


class _Loop:
    __slots__ = ("name", "periodic", "thread_name", "counter_fn", "beats")

    def __init__(self, name: str, periodic: bool, thread_name: Optional[str],
                 counter_fn: Optional[Callable[[], float]]) -> None:
        self.name = name
        self.periodic = periodic
        self.thread_name = thread_name
        self.counter_fn = counter_fn
        self.beats = 0.0


class WedgeWatchdog:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loops: Dict[str, _Loop] = {}

    def register(self, name: str, *, periodic: bool = False,
                 thread_name: Optional[str] = None,
                 counter_fn: Optional[Callable[[], float]] = None) -> None:
        """Register (or re-register) a loop; ``periodic=True`` has it
        stall-checked always."""
        with self._lock:
            self._loops[name] = _Loop(name, periodic, thread_name, counter_fn)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._loops.pop(name, None)

    def beat(self, name: str) -> None:
        """One iteration; an unregistered name registers as event-driven."""
        with self._lock:
            loop = self._loops.get(name)
            if loop is None:
                loop = self._loops[name] = _Loop(name, False, None, None)
            loop.beats += 1.0

    def counters(self) -> Dict[str, float]:
        """loop → its progress counter (``counter_fn``'s, else its beats);
        a failing callback is skipped for this sample."""
        with self._lock:
            loops = list(self._loops.values())
        out: Dict[str, float] = {}
        for loop in loops:
            if loop.counter_fn is not None:
                try:
                    out[loop.name] = float(loop.counter_fn())
                except Exception:
                    continue
            else:
                out[loop.name] = loop.beats
        return out

    def periodic_loops(self) -> List[str]:
        with self._lock:
            return sorted(n for n, loop in self._loops.items() if loop.periodic)

    def thread_name(self, name: str) -> Optional[str]:
        with self._lock:
            loop = self._loops.get(name)
            return loop.thread_name if loop else None

    def stacks_for(self, name: str) -> List[str]:
        """The profiler's collapsed stacks of the loop's thread: where a
        wedged loop is parked."""
        thread_name = self.thread_name(name)
        if not thread_name:
            return []
        from nos_tpu_torch.util.profiling import PROFILER

        return [line for line in PROFILER.collapsed().splitlines()
                if line.startswith(f"{thread_name};")]

    def debug_payload(self) -> dict:
        with self._lock:
            loops = sorted(self._loops.values(), key=lambda loop: loop.name)
            return {"loops": [{"name": loop.name, "periodic": loop.periodic,
                               "thread": loop.thread_name,
                               "external_counter": loop.counter_fn is not None,
                               "beats": loop.beats} for loop in loops]}


# the process-wide watchdog of the port
WATCHDOG = WedgeWatchdog()
