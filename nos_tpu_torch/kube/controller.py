"""The reconciler runtime: counterpart of ``nos_tpu/kube/controller.py``.

A ``Controller`` owns a work queue fed by store watch events through
predicates and request mappers (``Watch``), and calls
``reconcile(request)``; a ``Manager`` runs a set of controllers against
one store. ``_WorkQueue`` keeps client-go's semantics, as the
reference's does: a request already queued is not queued twice; a
request added while it is being processed runs again once it is done;
``Result(requeue=True)`` adds it back at once, ``requeue_after`` after
that many seconds; a reconcile that raises is requeued after 0.05 s. A
request waits for one delayed re-add at a time, the soonest asked for
(client-go's delaying queue): a reconcile that requeues itself on a
period, and runs on events between, keeps one period, not one more
each event.

Two ways to run them, the same queues either way:

- threaded, as the reference: ``Controller.start()`` / ``stop()`` run an
  event pump and a worker thread, and ``Manager.wait_idle`` blocks until
  every queue has stayed empty for ``settle`` seconds (delayed requeues
  do not count as busy). The work queue's delays run on
  ``time.monotonic``.
- synchronous, ``Controller.drain()`` / ``Manager.drain(names)``, in the
  caller's thread: each controller's pending watch events are dispatched
  and its due requests reconciled, over and over, until no drained
  controller has an event or a due request left (a reconcile's own writes
  included). A controller given a ``clock`` (a ``SimCluster``'s virtual
  one) times its ``requeue_after`` on it, so a delayed request comes due
  in the drain after the clock has passed it. This is the
  port's own addition (ROADMAP.md, the deliberate differences): a loop
  on a virtual clock steps its consumers in a fixed order, and each
  drains its watches where it reads.

Each controller meters its busy fraction (``BusyMeter``) and the age of
each event at dispatch (``WATCH_DRAIN_LAG``); a started one registers its
stats with ``LOOPS``, its pump and worker threads with the profiler, and
each of them with the watchdog as an event-driven loop
(``<name>-pump``, ``<name>-work``) that beats once an iteration: a
worker parked in a reconcile stops beating, which a timeline armed on its
``loop.<name>-work`` series reports as a stall.
"""
from __future__ import annotations

import heapq
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from nos_tpu_torch.kube.store import NodeStore, WatchEvent
from nos_tpu_torch.timeline.watchdog import WATCHDOG
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.loop_health import LOOPS, BusyMeter
from nos_tpu_torch.util.profiling import PROFILER

log = logging.getLogger("nos_tpu_torch.kube")

# reconciles one drain runs at most (a reconcile that requeues itself at
# once, every time, would never let a synchronous drain end)
DRAIN_LIMIT = 100_000
# the delay before a raising reconcile runs again
FAILURE_REQUEUE_SECONDS = 0.05


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str = ""

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


Predicate = Callable[[WatchEvent], bool]
Mapper = Callable[[WatchEvent], Sequence[Request]]


def default_mapper(event: WatchEvent) -> Sequence[Request]:
    return [Request(name=event.object.name, namespace=event.object.namespace)]


@dataclass
class Watch:
    kind: str
    predicate: Optional[Predicate] = None
    mapper: Mapper = default_mapper


class _WorkQueue:
    """A deduplicating work queue with delayed re-adds, on ``clock``."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._cond = threading.Condition()
        self._queue: List[Request] = []
        self._dirty: set = set()
        self._processing: set = set()
        self._delayed: List[Tuple[float, int, Request]] = []
        # request → the time its delayed re-add is due (one a request)
        self._waiting: Dict[Request, float] = {}
        self._seq = 0
        self._shutdown = False

    def add(self, req: Request) -> None:
        with self._cond:
            if req in self._dirty:
                return
            self._dirty.add(req)
            if req not in self._processing:
                self._queue.append(req)
            self._cond.notify()

    def add_after(self, req: Request, delay: float) -> None:
        if delay <= 0:
            self.add(req)
            return
        with self._cond:
            due = self.clock() + delay
            if self._waiting.get(req, due + 1) <= due:
                return  # already due sooner
            self._waiting[req] = due
            self._seq += 1
            heapq.heappush(self._delayed, (due, self._seq, req))
            self._cond.notify()

    def _promote_due(self) -> None:
        now = self.clock()
        while self._delayed and self._delayed[0][0] <= now:
            due, _, req = heapq.heappop(self._delayed)
            if self._waiting.get(req) != due:
                continue  # superseded by a sooner re-add
            del self._waiting[req]
            if req not in self._dirty:
                self._dirty.add(req)
                if req not in self._processing:
                    self._queue.append(req)

    def get(self, timeout: float = 0.2) -> Optional[Request]:
        """The next request, waiting up to ``timeout`` seconds (0: not at
        all); None when there is none."""
        with self._cond:
            deadline = time.monotonic() + timeout
            while True:
                self._promote_due()
                if self._queue:
                    req = self._queue.pop(0)
                    self._dirty.discard(req)
                    self._processing.add(req)
                    return req
                if self._shutdown:
                    return None
                wait = deadline - time.monotonic()
                if self._delayed:
                    wait = min(wait, self._delayed[0][0] - self.clock())
                if wait <= 0:
                    return None
                self._cond.wait(wait)

    def done(self, req: Request) -> None:
        with self._cond:
            self._processing.discard(req)
            if req in self._dirty:
                self._queue.append(req)
                self._cond.notify()

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def idle(self) -> bool:
        with self._cond:
            return not self._queue and not self._processing and not self._dirty


class Controller:
    """One reconciler and its watches."""

    def __init__(self, name: str, store: NodeStore,
                 reconciler: Callable[[Request], Optional[Result]], watches: Sequence[Watch],
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.store = store
        self.reconciler = reconciler
        self.watches = list(watches)
        self.queue = _WorkQueue(clock or time.monotonic)
        self.reconciles = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._event_queue: Optional["queue.Queue[WatchEvent]"] = None
        self._busy = BusyMeter(name)
        self._drain_lag = metrics.WATCH_DRAIN_LAG.labels(consumer=name)

    # ---------------------------------------------------------- events

    def subscribe(self) -> None:
        """Open the watch (once): the existing objects arrive first."""
        if self._event_queue is None:
            self._event_queue = self.store.watch({w.kind for w in self.watches},
                                                 name=self.name)

    def _dispatch(self, event: WatchEvent) -> None:
        if event.enqueued:
            self._drain_lag.observe(time.monotonic() - event.enqueued)
        for w in self.watches:
            if w.kind != event.kind:
                continue
            if w.predicate is not None and not w.predicate(event):
                continue
            for req in w.mapper(event):
                self.queue.add(req)

    def _pump_pending(self) -> None:
        eq = self._event_queue
        while True:
            try:
                event = eq.get_nowait()
            except queue.Empty:
                return
            self._dispatch(event)

    def _process(self, req: Request) -> None:
        t0 = time.monotonic()
        self.reconciles += 1
        try:
            result = self.reconciler(req)
        except Exception:
            log.exception("[%s] reconcile %s failed; requeuing", self.name,
                          req.namespaced_name)
            result = Result(requeue=True, requeue_after=FAILURE_REQUEUE_SECONDS)
        finally:
            self.queue.done(req)
            self._busy.record(time.monotonic() - t0)
        if result and result.requeue_after > 0:
            self.queue.add_after(req, result.requeue_after)
        elif result and result.requeue:
            self.queue.add(req)

    # ------------------------------------------------------------ drain

    def drain(self) -> int:
        """Dispatch the pending events and reconcile every due request,
        until neither is left; the reconciles run."""
        self.subscribe()
        done = 0
        while done < DRAIN_LIMIT:
            self._pump_pending()
            req = self.queue.get(timeout=0)
            if req is None:
                if self._event_queue.empty():
                    return done
                continue
            self._process(req)
            done += 1
        log.warning("[%s] a drain stopped after %d reconciles", self.name, done)
        return done

    # ---------------------------------------------------------- threads

    def _pump(self) -> None:
        beat = f"{self.name}-pump"
        PROFILER.register_thread()
        try:
            while not self._stop.is_set():
                WATCHDOG.beat(beat)
                try:
                    event = self._event_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                try:
                    self._dispatch(event)
                except Exception:  # pragma: no cover - defensive
                    log.exception("[%s] dispatch failed", self.name)
        finally:
            PROFILER.unregister_thread()

    def _work(self) -> None:
        beat = f"{self.name}-work"
        PROFILER.register_thread()
        try:
            while not self._stop.is_set():
                WATCHDOG.beat(beat)
                t0 = time.monotonic()
                req = self.queue.get(timeout=0.2)
                self._busy.record(0.0, idle_s=time.monotonic() - t0)
                if req is not None:
                    self._process(req)
        finally:
            PROFILER.unregister_thread()

    def start(self) -> None:
        self.subscribe()
        LOOPS.register(self.name, self._loop_stats)
        for target, label in ((self._pump, "pump"), (self._work, "work")):
            # both poll with a timeout and beat while idle, but work only
            # on events: event-driven loops
            thread_name = f"{self.name}-{label}"
            WATCHDOG.register(thread_name, periodic=False, thread_name=thread_name)
            t = threading.Thread(target=target, name=thread_name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self.queue.shut_down()
        LOOPS.unregister(self.name)
        for label in ("pump", "work"):
            WATCHDOG.unregister(f"{self.name}-{label}")
        if self._event_queue is not None:
            self.store.stop_watch(self._event_queue)
        if join:
            self.join()

    def join(self) -> None:
        for t in self._threads:
            t.join(timeout=2.0)

    def _loop_stats(self) -> dict:
        eq = self._event_queue
        stats = self._busy.snapshot()
        stats["event_queue_depth"] = eq.qsize() if eq is not None else 0
        stats["workqueue_idle"] = self.queue.idle()
        stats["reconciles"] = self.reconciles
        return stats

    def idle(self) -> bool:
        eq = self._event_queue
        return (eq is None or eq.empty()) and self.queue.idle()


class Manager:
    """A store and its controllers (one per component's manager), plus
    start / stop hooks of other runnables."""

    def __init__(self, store: NodeStore, controllers: Iterable[Controller] = ()) -> None:
        self.store = store
        self.controllers: List[Controller] = list(controllers)
        self._runnables: List[Callable[[], None]] = []
        self._stoppables: List[Callable[[], None]] = []

    def add(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def add_runnable(self, start: Callable[[], None], stop: Callable[[], None]) -> None:
        self._runnables.append(start)
        self._stoppables.append(stop)

    def start(self) -> None:
        for c in self.controllers:
            c.start()
        for r in self._runnables:
            r()

    def stop(self) -> None:
        for s in self._stoppables:
            s()
        # every controller told first, then joined: their last waits overlap
        for c in self.controllers:
            c.stop(join=False)
        for c in self.controllers:
            c.join()

    def drain(self, names: Optional[Iterable[str]] = None) -> int:
        """``Controller.drain`` over the named controllers (every one by
        default), in their order, until a pass finds none with work left;
        the reconciles run."""
        wanted = None if names is None else set(names)
        controllers = [c for c in self.controllers if wanted is None or c.name in wanted]
        total = 0
        while True:
            ran = sum(c.drain() for c in controllers)
            total += ran
            if not ran and all(c._event_queue.empty() for c in controllers):
                return total

    def wait_idle(self, timeout: float = 10.0, settle: float = 0.05) -> bool:
        """Block until every controller's queues are empty and stay empty
        for ``settle`` seconds; False at ``timeout``."""
        deadline = time.monotonic() + timeout
        idle_since: Optional[float] = None
        while time.monotonic() < deadline:
            if all(c.idle() for c in self.controllers):
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since >= settle:
                    return True
            else:
                idle_since = None
            time.sleep(0.01)
        return False
