"""Request-scoped tracing: the port's own copy of ``nos_tpu/util/tracing.py``.

- ``Span``: trace, span and parent ids, attributes, events, wall and
  perf clocks, the thread it ran on; ``to_chrome_events`` gives Chrome
  trace-event records (Perfetto loads them).
- Parenting rides ``contextvars``: ``TRACER.span(...)`` opens a child of
  the active span. A thread does not inherit them, so a handoff uses
  ``TRACER.attach(span)``, a keyed *journey* (a root registered under a
  key that later stages parent onto: a pod's, from its first observation
  to its bind) or a *link* (a span registered under a key for an
  out-of-context continuation: a partitioner's apply and the node
  agent's re-carve). A span that ends after its trace was stored joins
  the stored trace. ``plugin_span`` opens nothing while
  ``suppress_plugins`` is on (the planner's trials) or outside a trace.
- Finished traces land in a ``TraceStore``: a newest-kept ring and a
  tail-kept reservoir that a burst of boring traces cannot evict.
  ``classify_trace`` calls a trace ``error``, ``unschedulable`` (its root
  carries a ``diagnosis``), ``slow`` (past its root's threshold in the
  ``RetentionPolicy``) or ``boring``; an interesting one is pinned (and
  counted in ``nos_tpu_trace_retained_total``), a boring one kept one in
  ``boring_sample_n``. ``summaries_page`` pages the summaries newest
  first, ``retention_stats`` says what was seen and kept.
- ``current_phase(thread_id)``, the thread's innermost open span, is what
  the sampling profiler attributes a sample to.
- ``TraceContextFilter`` puts the active trace and span ids on every log
  record, ``JsonLogFormatter`` writes one JSON object a line, and
  ``configure_logging`` attaches both to the ``nos_tpu_torch`` loggers.

Every part is bounded (spans a trace, events a span, journeys, links,
stored traces); with ``TRACER.enabled = False`` every entry point returns
the shared no-op span.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
from collections import OrderedDict
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_ids = itertools.count(1)


def _new_id(prefix: str) -> str:
    return f"{prefix}{next(_ids):x}"


_current_span: ContextVar[Optional["Span"]] = ContextVar(
    "nos_tpu_torch_current_span", default=None
)
# thread id → the name of its innermost open span, written by span() and
# attach() of that thread only and read by the profiler's sampler (single
# dict operations: no lock on the span's path)
_thread_phases: Dict[int, str] = {}


def current_phase(thread_id: int) -> str:
    """The thread's innermost open span ("" outside one)."""
    return _thread_phases.get(thread_id, "")


_plugins_suppressed: ContextVar[bool] = ContextVar(
    "nos_tpu_torch_plugin_spans_suppressed", default=False
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Tuple[float, str, Dict[str, Any]]] = field(default_factory=list)
    start_wall: float = 0.0
    start_perf: float = 0.0
    duration_s: Optional[float] = None
    thread: str = ""
    status: str = "ok"

    MAX_EVENTS = 128

    @property
    def ended(self) -> bool:
        return self.duration_s is not None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_attributes(self, **attributes: Any) -> None:
        self.attributes.update(attributes)

    def add_event(self, name: str, **attributes: Any) -> None:
        if len(self.events) < self.MAX_EVENTS:
            self.events.append((time.time(), name, attributes))

    def to_chrome_events(self) -> List[Dict[str, Any]]:
        """An 'X' (complete) record, and an 'i' (instant) record an event."""
        args = dict(self.attributes)
        args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_id"] = self.parent_id
        args["status"] = self.status
        tid = self.thread or "main"
        out = [{"name": self.name, "cat": "nos_tpu", "ph": "X",
                "ts": round(self.start_wall * 1e6, 1),
                "dur": round((self.duration_s or 0.0) * 1e6, 1), "pid": 1, "tid": tid,
                "args": args}]
        for when, name, attributes in self.events:
            out.append({"name": name, "cat": "nos_tpu.event", "ph": "i", "s": "t",
                        "ts": round(when * 1e6, 1), "pid": 1, "tid": tid,
                        "args": dict(attributes)})
        return out


class _NoopSpan(Span):
    """Shared sink for disabled tracing: mutators do nothing."""

    def __init__(self) -> None:
        super().__init__(name="noop", trace_id="", span_id="")

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def set_attributes(self, **attributes: Any) -> None:
        pass

    def add_event(self, name: str, **attributes: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


@dataclass
class Trace:
    """A finished trace: the root plus every span that ended under it."""

    trace_id: str
    spans: List[Span]
    dropped_spans: int = 0

    @property
    def root(self) -> Optional[Span]:
        for span in self.spans:
            if span.parent_id is None:
                return span
        return self.spans[0] if self.spans else None

    def summary(self) -> Dict[str, Any]:
        """The root's children summed by name: where the time went."""
        root = self.root
        stages: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        if root is not None:
            for span in self.spans:
                if span.parent_id == root.span_id:
                    stages[span.name] = stages.get(span.name, 0.0) + (span.duration_s or 0.0)
                    counts[span.name] = counts.get(span.name, 0) + 1
        return {
            "trace_id": self.trace_id, "root": root.name if root else "",
            "attributes": dict(root.attributes) if root else {},
            "status": root.status if root else "",
            "start": root.start_wall if root else 0.0,
            "duration_s": round(root.duration_s or 0.0, 6) if root else 0.0,
            "spans": len(self.spans), "dropped_spans": self.dropped_spans,
            "stages": {name: {"total_s": round(total, 6), "count": counts[name]}
                       for name, total in sorted(stages.items())},
        }

    def to_chrome(self) -> Dict[str, Any]:
        events: List[Dict[str, Any]] = []
        for span in self.spans:
            events.extend(span.to_chrome_events())
        return {"displayTimeUnit": "ms", "otherData": {"trace_id": self.trace_id},
                "traceEvents": events}


@dataclass
class RetentionPolicy:
    """What is interesting, how many interesting traces are pinned, and
    how boring ones are sampled. The defaults keep every trace."""

    # the pinned reservoir of error, unschedulable and slow traces; 0: none
    tail_capacity: int = 64
    # keep 1 in N boring traces (by arrival); the others still count
    boring_sample_n: int = 1
    # root span name → seconds past which its trace is slow
    slow_thresholds: Dict[str, float] = field(default_factory=dict)


def classify_trace(trace: Trace, policy: RetentionPolicy) -> str:
    """'error' | 'unschedulable' | 'slow' | 'boring', the first that holds."""
    for span in trace.spans:
        if span.status == "error":
            return "error"
    root = trace.root
    if root is not None:
        if "diagnosis" in root.attributes:
            return "unschedulable"
        threshold = policy.slow_thresholds.get(root.name)
        if threshold is not None and (root.duration_s or 0.0) > threshold:
            return "slow"
    return "boring"


class TraceStore:
    """A newest-kept ring of finished traces, and the pinned reservoir
    interesting traces retire to."""

    def __init__(self, capacity: int = 256,
                 retention: Optional[RetentionPolicy] = None) -> None:
        self.capacity = max(1, capacity)
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()
        self._interesting: "OrderedDict[str, Trace]" = OrderedDict()
        self._lock = threading.Lock()
        self._retention = retention or RetentionPolicy()
        # trace id → (arrival seq, verdict): the seq orders both rings
        # newest first and is the paging cursor
        self._meta: Dict[str, Tuple[int, str]] = {}
        self._seq = 0
        self._seen: Dict[str, int] = {}
        self._kept: Dict[str, int] = {}
        self._sampled_out = 0

    def set_retention(self, policy: Optional[RetentionPolicy]) -> RetentionPolicy:
        """Swap the policy; the previous one."""
        policy = policy or RetentionPolicy()
        with self._lock:
            prev, self._retention = self._retention, policy
            while len(self._interesting) > max(0, policy.tail_capacity):
                evicted, _ = self._interesting.popitem(last=False)
                self._meta.pop(evicted, None)
        return prev

    def add(self, trace: Trace) -> None:
        verdict = classify_trace(trace, self._retention)
        pinned = False
        with self._lock:
            policy = self._retention
            self._seen[verdict] = self._seen.get(verdict, 0) + 1
            if verdict != "boring" and policy.tail_capacity > 0:
                pinned = True
                self._interesting[trace.trace_id] = trace
                self._interesting.move_to_end(trace.trace_id)
                while len(self._interesting) > policy.tail_capacity:
                    evicted, _ = self._interesting.popitem(last=False)
                    self._meta.pop(evicted, None)
            else:
                if verdict == "boring" and policy.boring_sample_n > 1:
                    # the 1st, N+1th, ... boring traces are kept
                    if (self._seen[verdict] - 1) % policy.boring_sample_n:
                        self._sampled_out += 1
                        return
                self._traces[trace.trace_id] = trace
                self._traces.move_to_end(trace.trace_id)
                while len(self._traces) > self.capacity:
                    evicted, _ = self._traces.popitem(last=False)
                    self._meta.pop(evicted, None)
            self._seq += 1
            self._meta[trace.trace_id] = (self._seq, verdict)
            self._kept[verdict] = self._kept.get(verdict, 0) + 1
        if pinned:
            from nos_tpu_torch.util import metrics

            metrics.TRACE_RETAINED.labels(verdict=verdict).inc()

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._traces.get(trace_id) or self._interesting.get(trace_id)

    def list(self) -> List[Trace]:
        """Newest first across both rings."""
        with self._lock:
            traces = list(self._traces.values()) + list(self._interesting.values())
            return sorted(traces, key=lambda t: self._meta.get(t.trace_id, (0, ""))[0],
                          reverse=True)

    def summaries(self) -> List[Dict[str, Any]]:
        return [self._summarize(t) for t in self.list()]

    def _summarize(self, trace: Trace) -> Dict[str, Any]:
        seq, verdict = self._meta.get(trace.trace_id, (0, ""))
        out = trace.summary()
        out["seq"] = seq
        out["verdict"] = verdict
        return out

    def summaries_page(self, limit: int = 0,
                       cursor: str = "") -> Tuple[List[Dict[str, Any]], str]:
        """A page of summaries, newest first; the cursor is the last
        summary's ``seq``, and a page holds the older ones."""
        traces = self.list()
        if cursor:
            after = int(cursor)
            traces = [t for t in traces if self._meta.get(t.trace_id, (0, ""))[0] < after]
        if limit and limit > 0:
            page, more = traces[:limit], len(traces) > limit
        else:
            page, more = traces, False
        summaries = [self._summarize(t) for t in page]
        next_cursor = str(summaries[-1]["seq"]) if summaries and more else ""
        return summaries, next_cursor

    def retention_stats(self) -> Dict[str, Any]:
        """Seen and kept by verdict, the boring weight, and ``hit_rate``:
        the share of interesting traces still kept."""
        with self._lock:
            seen = dict(sorted(self._seen.items()))
            kept = dict(sorted(self._kept.items()))
            interesting_seen = sum(n for v, n in seen.items() if v != "boring")
            pinned = len(self._interesting)
            return {"seen": seen, "kept": kept, "sampled_out": self._sampled_out,
                    "boring_weight": self._retention.boring_sample_n, "pinned": pinned,
                    "hit_rate": round(pinned / interesting_seen, 4)
                    if interesting_seen else 1.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces) + len(self._interesting)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._interesting.clear()
            self._meta.clear()
            self._seq = 0
            self._seen.clear()
            self._kept.clear()
            self._sampled_out = 0


class _ActiveTrace:
    __slots__ = ("spans", "dropped", "open_spans")

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.dropped = 0
        self.open_spans = 0


class Tracer:
    # spans kept a trace, live journeys and links: a long-running server
    # can leave tracing on
    MAX_SPANS_PER_TRACE = 4096
    MAX_JOURNEYS = 512
    MAX_LINKS = 1024

    def __init__(self, capacity: int = 256) -> None:
        self.enabled = True
        self.store = TraceStore(capacity)
        self._lock = threading.Lock()
        self._active: Dict[str, _ActiveTrace] = {}
        self._journeys: Dict[Any, Span] = {}
        self._links: Dict[Any, Span] = {}

    # ------------------------------------------------------- span lifecycle

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attributes: Any) -> Span:
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _current_span.get()
        if parent is NOOP_SPAN:
            parent = None
        elif parent is not None and parent.ended:
            # an ended parent anchors a span while its trace is reachable
            with self._lock:
                reachable = parent.trace_id in self._active
            if not reachable and self.store.get(parent.trace_id) is None:
                parent = None
        if parent is None:
            trace_id, parent_id = _new_id("t"), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(name=name, trace_id=trace_id, span_id=_new_id("s"), parent_id=parent_id,
                    attributes=dict(attributes), start_wall=time.time(),
                    start_perf=time.perf_counter(),
                    thread=threading.current_thread().name)
        with self._lock:
            if parent_id is None:
                self._active[trace_id] = _ActiveTrace()
            active = self._active.get(trace_id)
            if active is not None:
                active.open_spans += 1
        return span

    def end_span(self, span: Span, status: Optional[str] = None) -> None:
        if span is NOOP_SPAN or span.ended:
            return
        span.duration_s = time.perf_counter() - span.start_perf
        if status is not None:
            span.status = status
        with self._lock:
            active = self._active.get(span.trace_id)
            if active is not None:
                active.open_spans = max(0, active.open_spans - 1)
                if len(active.spans) < self.MAX_SPANS_PER_TRACE:
                    active.spans.append(span)
                else:
                    active.dropped += 1
                if span.parent_id is None:
                    self._finalize_locked(span.trace_id)
                return
        # a late span (a node agent's re-carve after the plan's trace
        # ended) joins the stored trace while it is kept
        stored = self.store.get(span.trace_id)
        if stored is not None:
            if len(stored.spans) < self.MAX_SPANS_PER_TRACE:
                stored.spans.append(span)
            else:
                stored.dropped_spans += 1

    def _finalize_locked(self, trace_id: str) -> None:
        active = self._active.pop(trace_id, None)
        if active is None or not active.spans:
            return
        self.store.add(Trace(trace_id=trace_id, spans=active.spans,
                             dropped_spans=active.dropped))

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None, **attributes: Any):
        """Open a span (parented on the active one unless ``parent`` is
        given), make it current, end it on exit; an exception marks it
        status=error and re-raises."""
        span = self.start_span(name, parent=parent, **attributes)
        if span is NOOP_SPAN:
            yield span
            return
        token = _current_span.set(span)
        tid = threading.get_ident()
        prev_phase = _thread_phases.get(tid)
        _thread_phases[tid] = span.name
        try:
            yield span
        except BaseException:
            self.end_span(span, status="error")
            raise
        finally:
            if prev_phase is None:
                _thread_phases.pop(tid, None)
            else:
                _thread_phases[tid] = prev_phase
            _current_span.reset(token)
            self.end_span(span)

    def plugin_span(self, name: str, **attributes: Any):
        """A scheduler plugin's span: nothing while plugins are suppressed
        or outside an open trace."""
        if not self.enabled or _plugins_suppressed.get() or _current_span.get() is None:
            return contextlib.nullcontext(NOOP_SPAN)
        return self.span(name, **attributes)

    def current(self) -> Optional[Span]:
        span = _current_span.get()
        return None if span is NOOP_SPAN else span

    @contextlib.contextmanager
    def attach(self, span: Optional[Span]):
        """Make ``span`` current in this thread (contextvars do not cross a
        thread's start)."""
        token = _current_span.set(span)
        tid = threading.get_ident()
        prev_phase = _thread_phases.get(tid)
        if span is not None and span is not NOOP_SPAN:
            _thread_phases[tid] = span.name
        try:
            yield span
        finally:
            if prev_phase is None:
                _thread_phases.pop(tid, None)
            else:
                _thread_phases[tid] = prev_phase
            _current_span.reset(token)

    @contextlib.contextmanager
    def suppress_plugins(self):
        token = _plugins_suppressed.set(True)
        try:
            yield
        finally:
            _plugins_suppressed.reset(token)

    # ------------------------------------------------------------ journeys

    def journey_root(self, key: Any, name: str, **attributes: Any) -> Span:
        """Get-or-create the root span registered under ``key``."""
        if not self.enabled:
            return NOOP_SPAN
        with self._lock:
            existing = self._journeys.get(key)
            if existing is not None and not existing.ended:
                return existing
        # parent=NOOP forces a fresh root under any active span
        span = self.start_span(name, parent=NOOP_SPAN, **attributes)
        with self._lock:
            raced = self._journeys.get(key)
            if raced is not None and not raced.ended:
                # another thread registered one first: keep it
                self._active.pop(span.trace_id, None)
                return raced
            self._journeys[key] = span
            evict = list(self._journeys)[: max(0, len(self._journeys) - self.MAX_JOURNEYS)]
        for stale in evict:
            self.end_journey(stale, status="abandoned")
        return span

    def journey(self, key: Any) -> Optional[Span]:
        with self._lock:
            span = self._journeys.get(key)
        if span is None or span.ended:
            return None
        return span

    def end_journey(self, key: Any, status: str = "ok", **attributes: Any) -> Optional[Span]:
        with self._lock:
            span = self._journeys.pop(key, None)
        if span is None or span is NOOP_SPAN:
            return None
        span.set_attributes(**attributes)
        self.end_span(span, status=status)
        return span

    # --------------------------------------------------------------- links

    def link(self, key: Any, span: Optional[Span]) -> None:
        """Register ``span`` as the parent of a later continuation that
        runs out of its context, the oldest link dropped past MAX_LINKS."""
        if span is None or span is NOOP_SPAN or not self.enabled:
            return
        with self._lock:
            self._links[key] = span
            while len(self._links) > self.MAX_LINKS:
                self._links.pop(next(iter(self._links)))

    def linked(self, key: Any, pop: bool = True) -> Optional[Span]:
        with self._lock:
            return self._links.pop(key, None) if pop else self._links.get(key)

    def reset(self) -> None:
        """Drop every live and stored trace (tests)."""
        with self._lock:
            self._active.clear()
            self._journeys.clear()
            self._links.clear()
        self.store.clear()


# The process-wide tracer of the port.
TRACER = Tracer()

# The health timeline watches the ring's size: one that keeps growing past
# its bound is a leak. (Imported after every definition: the timeline's
# store reaches this module through the profiler.)
from nos_tpu_torch.timeline.sizes import SIZES as _SIZES  # noqa: E402

_SIZES.register("tracing.trace_store", lambda: len(TRACER.store))


# ------------------------------------------------------------------ logging


class TraceContextFilter(logging.Filter):
    """Puts the active trace and span ids on every record
    (``%(trace_id)s``)."""

    def filter(self, record: logging.LogRecord) -> bool:
        span = _current_span.get()
        if span is None or span is NOOP_SPAN:
            record.trace_id = ""
            record.span_id = ""
        else:
            record.trace_id = span.trace_id
            record.span_id = span.span_id
        return True


class JsonLogFormatter(logging.Formatter):
    """One JSON object a line: ts, level, logger, message, the trace and
    span ids under a span, the exception's text when there is one."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {"ts": round(record.created, 6), "level": record.levelname,
                 "logger": record.name, "message": record.getMessage()}
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            entry["trace_id"] = trace_id
            entry["span_id"] = getattr(record, "span_id", "")
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


def configure_logging(json_format: bool = False, level: Optional[int] = None, stream=None,
                      logger_name: str = "nos_tpu_torch") -> logging.Handler:
    """A handler with the trace-context filter (and the JSON formatter)
    on the ``logger_name`` tree; the handler, for the caller to detach."""
    logger = logging.getLogger(logger_name)
    handler = logging.StreamHandler(stream)
    handler.addFilter(TraceContextFilter())
    if json_format:
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s [%(trace_id)s] %(message)s"))
    if level is not None:
        logger.setLevel(level)
    logger.addHandler(handler)
    return handler
