"""Event recording: counterpart of ``nos_tpu/kube/events.py`` (``:55-199``).

``EventRecorder.record(obj, reason, message)`` writes an ``Event``
through the store it was given (a ``NodeStore`` or the API-backed
``KubeApiStore``, one method surface): an identical (object, reason,
message) repeat bumps the stored event's ``count`` and
``last_timestamp`` instead of writing a duplicate (the event's name is a
digest of the five, so the dedup holds across recorders), and a token
bucket for each involved object (a burst of 25, then one every five
minutes, client-go's spam filter) drops floods and counts them in
``dropped``. ``events_for(obj)`` lists an object's events, oldest first.
Reasons come from ``api/v1alpha1/constants.py:EVENT_REASONS``; any other
raises. Every time is read from ``clock`` (``time.time`` by default; a
``SimCluster`` passes its virtual one). Events about a cluster-scoped
object (a node) land in ``default``. An event recorded under an open
span carries its trace id in the ``nos.nebuly.com/trace-id`` annotation
(``kubectl describe`` leads to ``/debug/traces``; a repeat points it at
its latest trace); the annotation is no part of the dedup digest. The
health timeline records ``HealthDegraded`` events, and the components
(``cmd/``) theirs: the scheduler's ``Scheduled`` / ``FailedScheduling``
/ ``Preempted``, the quota controllers' ``QuotaBorrowed`` /
``QuotaReclaimed``, the autoscaler's ``ScaledUp`` / ``ScaledDown`` /
``ScaledToZero`` / ``ColdStart``, the partitioner's ``CarveFailed`` /
``PartitioningApplied`` and the auditor's ``AuditViolation``. Events are
store writes (they bump the revision and wake the watches of their kind);
the snapshot maintainer, the capacity ledger and the flight recorder
pass over the ``Event`` kind.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.constants import EVENT_REASONS
from nos_tpu_torch.kube.objects import Event
from nos_tpu_torch.kube.store import AlreadyExistsError, NotFoundError
from nos_tpu_torch.util.tracing import TRACER

# the trace of the decision that recorded an event (not in the digest, or
# every trace would mint a new event instead of bumping the count)
TRACE_ID_ANNOTATION = "nos.nebuly.com/trace-id"

DEFAULT_BURST = 25
DEFAULT_REFILL_PER_SECOND = 1.0 / 300.0
# beyond this many buckets the least recently touched half is dropped
_MAX_BUCKETS = 4096


class _TokenBucket:
    __slots__ = ("tokens", "last_refill", "last_touch")

    def __init__(self, burst: float, now: float) -> None:
        self.tokens = burst
        self.last_refill = now
        self.last_touch = now


class EventRecorder:
    def __init__(self, store: Any, component: str = "", burst: int = DEFAULT_BURST,
                 refill_per_second: float = DEFAULT_REFILL_PER_SECOND,
                 clock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.component = component
        self.burst = float(burst)
        self.refill_per_second = refill_per_second
        self.clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[Tuple[str, str, str], _TokenBucket] = {}
        self.dropped = 0

    def record(self, obj: Any, reason: str, message: str,
               type: str = "Normal") -> Optional[Event]:
        """One occurrence; the stored event, or None when the rate limiter
        dropped it. ``obj`` is any stored kind."""
        if reason not in EVENT_REASONS:
            raise ValueError(f"event reason {reason!r} is not in "
                             "nos_tpu_torch.api.v1alpha1.constants.EVENT_REASONS")
        kind, ns, name = obj.kind, obj.namespace, obj.name
        if not self._allow(kind, ns, name):
            with self._lock:
                self.dropped += 1
            return None
        now = self.clock()
        event_name = self._event_name(kind, ns, name, reason, message)
        event_ns = ns or "default"
        span = TRACER.current()
        trace_id = span.trace_id if span is not None else ""

        def bump(ev: Event) -> None:
            ev.count += 1
            ev.last_timestamp = now
            if trace_id:
                ev.annotations[TRACE_ID_ANNOTATION] = trace_id

        try:
            return self.store.patch_merge("Event", event_name, event_ns, bump)
        except NotFoundError:
            pass
        ev = Event(event_name, event_ns, involved_kind=kind, involved_namespace=ns,
                   involved_name=name, reason=reason, message=message, type=type, count=1,
                   first_timestamp=now, last_timestamp=now, source_component=self.component,
                   annotations={TRACE_ID_ANNOTATION: trace_id} if trace_id else {})
        try:
            return self.store.create(ev)
        except AlreadyExistsError:
            # another recorder wrote it first
            return self.store.patch_merge("Event", event_name, event_ns, bump)

    def events_for(self, obj: Any) -> List[Event]:
        """The stored events about ``obj``, oldest first."""
        kind, ns, name = obj.kind, obj.namespace, obj.name
        out = [e for e in self.store.list("Event", namespace=ns or "default")
               if e.involved_kind == kind and e.involved_namespace == ns
               and e.involved_name == name]
        out.sort(key=lambda e: e.first_timestamp)
        return out

    def _allow(self, kind: str, ns: str, name: str) -> bool:
        key = (kind, ns, name)
        now = self.clock()
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= _MAX_BUCKETS:
                    stale = sorted(self._buckets.items(),
                                   key=lambda kv: kv[1].last_touch)[: _MAX_BUCKETS // 2]
                    for k, _ in stale:
                        del self._buckets[k]
                bucket = _TokenBucket(self.burst, now)
                self._buckets[key] = bucket
            else:
                elapsed = max(0.0, now - bucket.last_refill)
                bucket.tokens = min(self.burst, bucket.tokens + elapsed * self.refill_per_second)
                bucket.last_refill = now
            bucket.last_touch = now
            if bucket.tokens < 1.0:
                return False
            bucket.tokens -= 1.0
            return True

    @staticmethod
    def _event_name(kind: str, ns: str, name: str, reason: str, message: str) -> str:
        """One name per (object, reason, message), so the dedup holds across
        recorders and restarts."""
        digest = hashlib.sha1("\x00".join((kind, ns, name, reason, message)).encode()
                              ).hexdigest()[:12]
        return f"{name}.{digest}"
