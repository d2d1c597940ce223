"""PlacementForecaster: the wired forecast subsystem, polled.

Counterpart of ``nos_tpu/forecast/forecaster.py`` (``notify_cycle``,
``run_once``, ``_publish``, ``_on_gang_bound``, ``stale_feasible_now``,
``debug_payload``). The partitioner controller calls ``notify_cycle``
after each plan (the reference's hook, its ``controller.py:533``): it
stashes the cycle's pending pods and time and keeps the measured cycle
cadence. ``run_once`` forecasts on the forecaster's own planner and its
own ``IncrementalSnapshotMaintainer`` (never the control loop's), runs
the defrag advisor, and publishes: the gangs' ETAs
(``nos_tpu_gang_eta_seconds``), the unsafe backfills, the runs, and one
stamp a gang. When the capacity ledger sees a gang bind, its gang-bound
listener joins the bind against the gang's last stamp into the
calibration tracker (``nos_tpu_forecast_accuracy_ratio``).

No thread and no wall clock: whoever drives the loop calls ``step``
(``SimCluster``, each of its steps: one run when a plan notified a
cycle, at that cycle's time, the store's virtual clock there), or
``run_once`` with an explicit ``now`` and pending set (the bench). The
reference's forecasting thread, its throttle, the watchdog and the
profiler registrations and the flight records wait for the
observability slice (ROADMAP.md, item 18b). The forecaster never writes
to the store. With ``cluster_state`` None it keeps its own, synced from
the store at each run (the reference's taker reads the store there).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from nos_tpu_torch.controllers.partitioner.incremental import IncrementalSnapshotMaintainer
from nos_tpu_torch.forecast.accuracy import CalibrationTracker
from nos_tpu_torch.forecast.advisor import DefragAdvisor
from nos_tpu_torch.forecast.engine import STAGE_FEASIBLE_NOW, ForecastEngine
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.partitioning.core.state import ClusterState
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.forecast")


class PlacementForecaster:
    def __init__(self, store: NodeStore, cluster_state: Optional[ClusterState], planner,
                 snapshot_taker, kind: str = "mig", capacity_ledger=None,
                 default_reconfig_seconds: float = 0.5) -> None:
        self.store = store
        self._own_state = cluster_state is None
        self.cluster_state = ClusterState() if cluster_state is None else cluster_state
        self.kind = kind
        self.ledger = capacity_ledger
        self.default_reconfig_seconds = default_reconfig_seconds
        self.engine = ForecastEngine(planner)
        self.advisor = DefragAdvisor(self.engine)
        self._maintainer = IncrementalSnapshotMaintainer(store, snapshot_taker,
                                                         kind=f"{kind}-forecast")
        self.calibration = CalibrationTracker()
        self._lock = threading.Lock()
        # gang → its last published forecast's {now, eta_seconds, stage}
        self._outstanding: Dict[str, Dict[str, Any]] = {}
        # gang → since when it has been forecast feasible-now
        self._feasible_since: Dict[str, float] = {}
        self._last_payload: Optional[Dict[str, Any]] = None
        self._pending_batch: List[Any] = []
        self._batch_now: Optional[float] = None
        # the measured cycle cadence (an EWMA of the notify intervals):
        # "feasible now binds next cycle"
        self._cycle_seconds = 1.0
        self._last_notify: Optional[float] = None
        self._notified = False
        self.runs = 0
        self.backfill_unsafe_total = 0
        if capacity_ledger is not None:
            capacity_ledger.add_gang_bound_listener(self._on_gang_bound)

    # ------------------------------------------------------------- triggers

    def notify_cycle(self, pending, now: float) -> None:
        """The partitioner's cycle hook: stash the batch and its time."""
        with self._lock:
            if self._last_notify is not None:
                interval = max(0.0, now - self._last_notify)
                if 0.0 < interval < 60.0:
                    self._cycle_seconds = 0.7 * self._cycle_seconds + 0.3 * interval
            self._last_notify = now
            self._pending_batch = list(pending)
            self._batch_now = now
            self._notified = True

    def step(self) -> Optional[Dict[str, Any]]:
        """Run once if a cycle was notified since the last run (the
        reference's thread, woken by ``notify_cycle``)."""
        with self._lock:
            due, self._notified = self._notified, False
        return self.run_once() if due else None

    # ------------------------------------------------------------- forecast

    def run_once(self, now: Optional[float] = None, pending=None,
                 cycle_seconds: Optional[float] = None,
                 reconfig_seconds: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One forecast over the stashed batch (or ``pending``) at the
        batch's time (or ``now``); the published payload, or None when
        no cycle was notified and no time given."""
        with self._lock:
            if pending is None:
                pending = list(self._pending_batch)
            if now is None:
                now = self._batch_now
            if cycle_seconds is None:
                cycle_seconds = self._cycle_seconds
        if now is None:
            return None
        if reconfig_seconds is None:
            reconfig_seconds = self._measured_reconfig_seconds()
        clocks = self.ledger.gang_clocks() if self.ledger is not None else {}
        with TRACER.span("forecast.cycle", pending=len(pending)) as span:
            snapshot, dirty = self._snapshot()
            result = self.engine.forecast(snapshot, pending, now, clocks=clocks,
                                          cycle_seconds=cycle_seconds,
                                          reconfig_seconds=reconfig_seconds)
            result.advisor = self.advisor.advise(snapshot, pending, result.gangs, now,
                                                 clocks=clocks, cycle_seconds=cycle_seconds,
                                                 reconfig_seconds=reconfig_seconds)
            span.set_attributes(gangs=len(result.gangs), backfill_unsafe=result.unsafe_count,
                                dirty_nodes=len(dirty))
        self._publish(result, now)
        payload = result.payload()
        with self._lock:
            self._last_payload = payload
        return payload

    def _snapshot(self):
        if self._own_state:
            self._sync_state()
        return self._maintainer.snapshot(self.cluster_state)

    def _sync_state(self) -> None:
        """The private ClusterState := the store's nodes and their bound
        pods."""
        by_node = self.store.pods_by_node()
        names = set()
        for node in self.store.list("Node", copy=False):
            self.cluster_state.update_node(node, list(by_node.get(node.name, ())))
            names.add(node.name)
        for name in self.cluster_state.node_names():
            if name not in names:
                self.cluster_state.delete_node(name)

    def _measured_reconfig_seconds(self) -> float:
        if self.ledger is not None:
            return self.ledger.mean_reconfig_seconds(default=self.default_reconfig_seconds)
        return self.default_reconfig_seconds

    def _publish(self, result, now: float) -> None:
        self.runs += 1
        metrics.FORECAST_RUNS.inc()
        unsafe = result.unsafe_count
        if unsafe:
            self.backfill_unsafe_total += unsafe
            metrics.BACKFILL_UNSAFE_TOTAL.inc(unsafe)
        stamps: Dict[str, Dict[str, Any]] = {}
        for gang in result.gangs:
            if gang.eta_seconds is not None:
                metrics.GANG_ETA_SECONDS.labels(stage=gang.stage).observe(gang.eta_seconds)
            stamps[gang.gang] = {"now": now, "eta_seconds": gang.eta_seconds,
                                 "stage": gang.stage}
        with self._lock:
            # replaced whole: a forecast covers the pending gangs only, the
            # others bound (the listener took them) or gone
            self._outstanding = stamps
            for gang in result.gangs:
                if gang.stage == STAGE_FEASIBLE_NOW:
                    self._feasible_since.setdefault(gang.gang, now)
                else:
                    self._feasible_since.pop(gang.gang, None)
            live = {g.gang for g in result.gangs}
            for key in [k for k in self._feasible_since if k not in live]:
                del self._feasible_since[key]

    # ---------------------------------------------------- accuracy joining

    def _on_gang_bound(self, gang: str, now: float, wait_seconds: float) -> None:
        """The ledger's gang-bound listener: join the bind against the
        gang's last published forecast."""
        with self._lock:
            stamp = self._outstanding.pop(gang, None)
            self._feasible_since.pop(gang, None)
            if stamp is None:
                return
            actual = max(0.0, now - stamp["now"])
            sample = self.calibration.add(stamp["eta_seconds"], actual, wait_seconds,
                                          stage=stamp["stage"])
            payload = self.calibration.payload()
        if sample is not None:
            metrics.FORECAST_ACCURACY_RATIO.labels(quantile="p50").set(payload["p50_ratio"])
            metrics.FORECAST_ACCURACY_RATIO.labels(quantile="p95").set(payload["p95_ratio"])

    # --------------------------------------------------------------- checks

    def stale_feasible_now(self, now: float) -> List[str]:
        """The gangs forecast feasible-now for longer than three measured
        cycles without binding."""
        with self._lock:
            limit_seconds = 3.0 * self._cycle_seconds
            return sorted(gang for gang, since in self._feasible_since.items()
                          if now - since > limit_seconds)

    def debug_payload(self) -> Dict[str, Any]:
        """The forecaster's state and its last forecast."""
        with self._lock:
            return {"kind": self.kind, "runs": self.runs,
                    "cycle_seconds": self._cycle_seconds,
                    "reconfig_seconds": self._measured_reconfig_seconds(),
                    "outstanding": len(self._outstanding),
                    "backfill_unsafe_total": self.backfill_unsafe_total,
                    "calibration": self.calibration.payload(),
                    "forecast": self._last_payload}
