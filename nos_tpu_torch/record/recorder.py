"""FlightRecorder: the control plane's decision log.

Counterpart of ``nos_tpu/record/recorder.py``. Two record streams share
one bounded ring, ordered by a process-wide sequence number:

- ``delta`` records: every store write (ADDED / MODIFIED / DELETED) of
  the kinds decisions read, as ``kube/flatwire.py``'s documents, keyed by
  the store revision the write was stamped with (``WatchEvent.revision``,
  the counter a decision's watermark reads). Together they rebuild the
  cluster at any watermark. The flat wire, not the Kubernetes one
  (``kube/serde.py``): the latter writes a pod's creation time to the
  second, and the planner orders pods tied on priority by it.
- decision records: one a control cycle (``scheduler.cycle``,
  ``planner.plan``, ``quota.reconcile``, ``actuation``,
  ``capacity.observe``, ``forecast.cycle`` / ``forecast.outcome``,
  ``timeline.finding``, ``audit``, ``pool.escalation``), carrying the
  revision read at the cycle's entry (so replay knows which deltas the
  decision saw), its outputs, clock stamps and the trace id.

Deltas arrive on a watch queue drained by a daemon thread, so they can
lag the decision records the deciding threads write: replay orders
deltas by revision, never by arrival. ``detach`` drains what is still
queued, so an export right after it holds every write made before it.
The ring is bounded (the oldest records fall off), and its length is
the health timeline's ``size.record.flight_ring``. Every record's ``ts``
reads ``clock`` (``time.time``; give the store's clock where it is not
the wall's): replay's store reads a decision's time from it.
"""
from __future__ import annotations

import itertools
import json
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

from nos_tpu_torch.kube import flatwire
from nos_tpu_torch.timeline.sizes import SIZES

# the kinds replay rebuilds decision inputs from; events are left out on
# purpose: they are telemetry a decision writes, never one it reads
RECORDED_KINDS = (
    "Pod",
    "Node",
    "ConfigMap",
    "PodDisruptionBudget",
    "ElasticQuota",
    "CompositeElasticQuota",
)

DEFAULT_CAPACITY = 4096


def load_jsonl(path: str) -> List[dict]:
    """An exported decision log, back as record dicts."""
    records: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, seed: int = 0,
                 clock: Callable[[], float] = time.time) -> None:
        self.capacity = capacity
        self.clock = clock
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        # replace-by-name: the newest recorder is the one watched
        SIZES.register("record.flight_ring", lambda: len(self._ring))
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._store = None
        self._queue = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the session header: the clocks every later stamp reads against
        # and the seed (kept for provenance)
        self._append("session.start", revision=0, seed=seed, wall_time=clock(),
                     monotonic=time.monotonic())

    # ------------------------------------------------------------ ring

    def _append(self, kind: str, **payload: Any) -> dict:
        with self._lock:
            record = {"seq": next(self._seq), "kind": kind, "ts": self.clock()}
            record.update(payload)
            self._ring.append(record)
        return record

    def records(self) -> List[dict]:
        """The ring, in sequence order."""
        with self._lock:
            return list(self._ring)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(r, sort_keys=True) for r in self.records())

    def export_jsonl(self, path: str) -> int:
        """Write the ring as JSONL; the records written."""
        records = self.records()
        with open(path, "w") as fh:
            for record in records:
                fh.write(json.dumps(record, sort_keys=True) + "\n")
        return len(records)

    # ----------------------------------------------------- delta stream

    def attach(self, store, kinds: Iterable[str] = RECORDED_KINDS) -> None:
        """Record every write to ``kinds`` as a ``delta``: the objects
        already stored come first as ADDED (the watch's replay), so a
        recorder attached before traffic holds the whole initial state."""
        if self._store is not None:
            raise RuntimeError("the recorder is already attached")
        self._store = store
        self._queue = store.watch(kinds, name="flight-recorder")
        self._stop.clear()
        self._thread = threading.Thread(target=self._drain_loop, name="flight-recorder",
                                        daemon=True)
        self._thread.start()

    def detach(self) -> None:
        """Stop the delta stream, then record what is still queued."""
        if self._store is None:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.drain()
        self._store.stop_watch(self._queue)
        self._store = None
        self._queue = None

    def drain(self) -> int:
        """Record every delta queued now; the deltas recorded (a caller
        that must see its writes in the ring calls it, or ``detach``)."""
        q = self._queue
        n = 0
        while q is not None:
            try:
                event = q.get_nowait()
            except queue_mod.Empty:
                break
            self._record_delta(event)
            n += 1
        return n

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            self._record_delta(event)

    def _record_delta(self, event) -> None:
        try:
            doc = flatwire.to_wire(event.object)
        except KeyError:
            return  # a kind without a flat document: no decision reads it
        self._append("delta", type=event.type, revision=event.revision, object=doc)

    # -------------------------------------------------- decision stream

    def record_session_meta(self, **meta: Any) -> None:
        """Session facts replay needs (the scheduler's name, the gang
        timeout, the planners' aging), folded into ``session.start``."""
        with self._lock:
            for record in self._ring:
                if record["kind"] == "session.start":
                    record.update(meta)
                    return

    def record_scheduler_cycle(self, *, pod: str, revision: int, decision: str,
                               node: str = "", bound: Optional[List[List[str]]] = None,
                               victims: Optional[List[str]] = None, message: str = "",
                               trace_id: str = "", diagnosis: Optional[dict] = None,
                               settled: bool = True) -> None:
        self._append("scheduler.cycle", pod=pod, revision=revision, decision=decision,
                     node=node, bound=bound or [], victims=victims or [], message=message,
                     trace_id=trace_id, diagnosis=diagnosis, settled=settled,
                     monotonic=time.monotonic())

    def record_plan(self, *, kind: str, revision: int, pending: List[str],
                    pending_ages: Dict[str, float], plan_id: str, desired: dict,
                    unserved: Dict[str, str], applied: int, trace_id: str = "") -> None:
        self._append("planner.plan", partitioner_kind=kind, revision=revision,
                     pending=pending, pending_ages=pending_ages, plan_id=plan_id,
                     desired=desired, unserved=unserved, applied=applied, trace_id=trace_id,
                     monotonic=time.monotonic())

    def record_quota_reconcile(self, *, quota: str, revision: int, used: Dict[str, float],
                               flips: List[List[str]]) -> None:
        """One quota reconcile: the usage published and the capacity-label
        flips ([pod key, new label]) it made."""
        self._append("quota.reconcile", quota=quota, revision=revision, used=used,
                     flips=flips)

    def record_actuation(self, *, kind: str, plan_id: str, revision: int,
                         applied: int) -> None:
        self._append("actuation", partitioner_kind=kind, plan_id=plan_id, revision=revision,
                     applied=applied)

    def record_pool_escalation(self, *, kind: str, pool: str, revision: int,
                               reason: str) -> None:
        """A process-backend pool whose worker could not serve the cycle,
        planned in the parent instead. Replay ignores it (the plan is in
        the plan record); a postmortem lines worker deaths up with it."""
        self._append("pool.escalation", partitioner_kind=kind, pool=pool, revision=revision,
                     reason=reason)

    def record_audit(self, *, revision: int, violations: List[dict]) -> None:
        self._append("audit", revision=revision, violations=violations)

    def record_capacity(self, *, revision: int, now: float, reason: Optional[str],
                        totals: dict, trace_id: str = "") -> None:
        """One ``CapacityLedger.observe``: the watermark it applied to, the
        time it integrated to (replay re-integrates from these, never from
        its own clock), the pending reason for the next interval, and the
        cumulative GB-second totals."""
        self._append("capacity.observe", revision=revision, now=now, reason=reason,
                     totals=totals, trace_id=trace_id)

    def record_forecast(self, *, revision: int, now: float, gangs: List[dict],
                        backfill_unsafe: int, advisor_validated: bool,
                        trace_id: str = "") -> None:
        """One forecast: every published gang ETA, the unsafe backfill
        count and whether the advisor's proposal validated."""
        self._append("forecast.cycle", revision=revision, now=now, gangs=gangs,
                     backfill_unsafe=backfill_unsafe, advisor_validated=advisor_validated,
                     trace_id=trace_id)

    def record_forecast_outcome(self, *, gang: str, now: float, stage: str,
                                eta_seconds: Optional[float], actual_seconds: float,
                                wait_seconds: float, calibration: dict) -> None:
        """One forecast-to-bind join, with the calibration it left: replay
        re-feeds the joins through a shadow tracker and compares."""
        self._append("forecast.outcome", gang=gang, now=now, stage=stage,
                     eta_seconds=eta_seconds, actual_seconds=actual_seconds,
                     wait_seconds=wait_seconds, calibration=calibration)

    def record_timeline_finding(self, *, t: float, detector: str, series: str,
                                window: List[List[float]], params: dict, verdict: dict,
                                stacks: Optional[List[str]] = None) -> None:
        """One new health-timeline finding with its detector's inputs (the
        window and the parameters): replay re-runs the detector on them.
        ``stacks`` (the wedged thread's) are context, outside the
        comparison."""
        self._append("timeline.finding", t=t, detector=detector, series=series, window=window,
                     params=params, verdict=verdict, stacks=stacks or [])
