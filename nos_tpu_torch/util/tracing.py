"""Request-scoped tracing: the port's own trimmed copy.

Keeps the tracer surface the serving telemetry uses from
``nos_tpu/util/tracing.py``: spans with trace/span/parent ids and
attributes, implicit parenting through ``contextvars``, keyed *journeys*
(a root span registered under a key that later stages parent onto), a
bounded ring of finished traces, links (a span registered under a key
for an out-of-context continuation to parent onto: a partitioner's apply
and the node agent's re-carve) and the shared no-op span returned while
tracing is disabled. The reference's retention policies, Chrome export
and profiler phase registry are left out.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import OrderedDict
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_ids = itertools.count(1)


def _new_id(prefix: str) -> str:
    return f"{prefix}{next(_ids):x}"


_current_span: ContextVar[Optional["Span"]] = ContextVar(
    "nos_tpu_torch_current_span", default=None
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    start_wall: float = 0.0
    start_perf: float = 0.0
    duration_s: Optional[float] = None
    status: str = "ok"

    @property
    def ended(self) -> bool:
        return self.duration_s is not None

    def set_attributes(self, **attributes: Any) -> None:
        self.attributes.update(attributes)


class _NoopSpan(Span):
    """Shared sink for disabled tracing: mutators do nothing."""

    def __init__(self) -> None:
        super().__init__(name="noop", trace_id="", span_id="")

    def set_attributes(self, **attributes: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


@dataclass
class Trace:
    """A finished trace: the root plus every span that ended under it."""

    trace_id: str
    spans: List[Span]

    @property
    def root(self) -> Optional[Span]:
        for span in self.spans:
            if span.parent_id is None:
                return span
        return self.spans[0] if self.spans else None


class TraceStore:
    """Bounded ring of finished traces, newest kept."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = max(1, capacity)
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()
        self._lock = threading.Lock()

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._traces[trace.trace_id] = trace
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def list(self) -> List[Trace]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._traces.values()))


class Tracer:
    # Per-trace span cap and live-journey cap: a long-running server can
    # leave tracing on without growing without bound.
    MAX_SPANS_PER_TRACE = 4096
    MAX_JOURNEYS = 512
    MAX_LINKS = 1024

    def __init__(self, capacity: int = 256) -> None:
        self.enabled = True
        self.store = TraceStore(capacity)
        self._lock = threading.Lock()
        self._active: Dict[str, List[Span]] = {}
        self._journeys: "OrderedDict[Any, Span]" = OrderedDict()
        self._links: Dict[Any, Span] = {}

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attributes: Any) -> Span:
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _current_span.get()
        if parent is NOOP_SPAN:
            parent = None
        span = Span(
            name=name,
            trace_id=parent.trace_id if parent else _new_id("t"),
            span_id=_new_id("s"),
            parent_id=parent.span_id if parent else None,
            attributes=dict(attributes),
            start_wall=time.time(),
            start_perf=time.perf_counter(),
        )
        if parent is None:
            with self._lock:
                self._active[span.trace_id] = []
        return span

    def end_span(self, span: Span, status: Optional[str] = None) -> None:
        if span is NOOP_SPAN or span.ended:
            return
        span.duration_s = time.perf_counter() - span.start_perf
        if status is not None:
            span.status = status
        with self._lock:
            spans = self._active.get(span.trace_id)
            if spans is None:
                return  # its trace already finished
            if len(spans) < self.MAX_SPANS_PER_TRACE:
                spans.append(span)
            if span.parent_id is None:
                del self._active[span.trace_id]
                self.store.add(Trace(trace_id=span.trace_id, spans=spans))

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
        try:
            yield span
        except BaseException:
            self.end_span(span, status="error")
            raise
        finally:
            _current_span.reset(token)
            self.end_span(span)

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

    def link(self, key: Any, span: Optional[Span]) -> None:
        """Register ``span`` as the parent of a later continuation that
        runs out of its context (a node's spec annotation, then the
        agent's re-carve), the oldest link dropped past MAX_LINKS."""
        if span is None or span is NOOP_SPAN or not self.enabled:
            return
        with self._lock:
            self._links[key] = span
            while len(self._links) > self.MAX_LINKS:
                self._links.pop(next(iter(self._links)))

    def linked(self, key: Any, pop: bool = True) -> Optional[Span]:
        with self._lock:
            return self._links.pop(key, None) if pop else self._links.get(key)


# The process-wide tracer of the port.
TRACER = Tracer()
