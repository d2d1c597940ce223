"""Batcher: dual-window event coalescing, polled.

Counterpart of ``nos_tpu/util/batcher.py:19-100`` (reference
pkg/util/batcher.go:25-130): items gather in a batch that is released
when either the *timeout window* (the longest wait, from the first add)
or the *idle window* (quiet time since the last add) has passed. The
defaults are the reference's helm values (values.yaml:278-285): 60 s and
10 s. The port's controllers poll, so there is no timer thread: ``poll``
releases the batch once a window has passed on ``clock`` (injectable, so
tests and the in-process cluster drive time themselves), or at once
after ``fire_now`` (the reference's immediate trigger: the next poll
releases the batch, an empty one included). ``wait(timeout)`` is the
blocking poll a batch thread sleeps on (the reference's ``ready``): it
wakes at the batch's deadline, at an ``add`` or ``fire_now``, or at
``timeout``, on a clock that is wall or monotonic time.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")

DEFAULT_TIMEOUT_SECONDS = 60.0
DEFAULT_IDLE_SECONDS = 10.0


class Batcher(Generic[T]):
    def __init__(self, timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
                 idle_seconds: float = DEFAULT_IDLE_SECONDS,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout = timeout_seconds
        self.idle = idle_seconds
        self.clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._batch: List[T] = []
        self._first_add = 0.0
        self._last_add = 0.0
        self._fired = False

    def add(self, item: T) -> None:
        with self._lock:
            now = self.clock()
            if not self._batch:
                self._first_add = now
            self._last_add = now
            self._batch.append(item)
            self._cond.notify_all()

    def fire_now(self) -> None:
        """Release the batch at the next poll, however young or empty."""
        with self._lock:
            self._fired = True
            self._cond.notify_all()

    def current_batch_size(self) -> int:
        with self._lock:
            return len(self._batch)

    def _due(self) -> Optional[float]:
        if not self._batch:
            return None
        due = self._first_add + self.timeout
        if self.idle > 0:
            due = min(due, self._last_add + self.idle)
        return due

    def deadline(self) -> Optional[float]:
        """When the current batch is due on ``clock``; None when empty."""
        with self._lock:
            return self._due()

    def _release(self) -> Optional[List[T]]:
        due = self._due()
        if not self._fired and (due is None or self.clock() < due):
            return None
        self._fired = False
        released, self._batch = self._batch, []
        return released

    def poll(self) -> Optional[List[T]]:
        """The released batch, or None while no window has passed."""
        with self._lock:
            return self._release()

    def wait(self, timeout: float) -> Optional[List[T]]:
        """The released batch, waiting up to ``timeout`` seconds for a
        window to pass or a ``fire_now``; None at the timeout."""
        end = time.monotonic() + timeout
        with self._lock:
            while True:
                released = self._release()
                if released is not None:
                    return released
                left = end - time.monotonic()
                if left <= 0:
                    return None
                due = self._due()
                if due is not None:
                    left = min(left, max(due - self.clock(), 0.001))
                self._cond.wait(left)
