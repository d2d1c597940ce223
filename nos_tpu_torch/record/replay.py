"""ReplaySession: re-run a recorded decision log offline.

Counterpart of ``nos_tpu/record/replay.py``. The recorded deltas are the
cluster's history: replay applies them to a ``NodeStore`` of its own
(``apply_event``, in revision order, ``kube/flatwire.py``'s documents),
pausing at each decision's watermark to re-run the decision on exactly
the state it saw live. Decisions run in watermark order (a plan's record
is written at its end, after cycles that ran beside it, but its
watermark was read at its start) through ONE scheduler and one planner a
partitioning mode (``mig``, ``mps``), so the in-memory state that
depends on order (the assume cache, the gangs, the quota reservations,
the MIG snapshot taker's refusals) builds up as it did live. The replay
store's clock reads the time of the record being replayed.

Drift is compared decision by decision:

- ``scheduler.cycle``: (decision, node, the bound pairs, the victims),
  from ``Scheduler.decide`` and, where the live writes landed,
  ``settle``;
- ``planner.plan``: the desired state of a plan from scratch (a fresh
  snapshot of the replay store, ``state_from_store``; the recorded ages)
  against the recorded one, unordered and blind to empty GPUs; the live
  plan was incremental, so this is also an end-to-end check of
  incremental planning;
- ``capacity.observe``: a shadow ``CapacityLedger`` on the replay store,
  built before any delta and observed at the recorded times with the
  recorded labels, must hold the recorded totals bit for bit (JSON keeps
  every double);
- ``forecast.outcome``: the joins re-fed through a shadow
  ``CalibrationTracker`` must leave the recorded calibration;
- ``timeline.finding``: the detector re-run on the recorded window and
  parameters must give the recorded verdict.

After each replayed plan, and each observation, the auditor runs
exhaustively (every entry, every plan). A decision whose pod does not
resolve at its watermark, or a plan of an unknown mode, is a skip, not
drift; quota reconciles, actuations and audits are informational (their
consequences are deltas). A sharded live plan can differ from an
unsharded replay where the draw does not decompose by pool (fault F7,
the reference's); replay plans unsharded.

``ReplayReport.seconds`` and ``audit_seconds`` time the run and its
audits on the host (outside the report's comparison).

A log whose ring wrapped (its oldest record is not the ``session.start``
header of seq 1) lost its session facts and the earliest writes, so no
verdict on it would mean anything: ``ReplaySession`` refuses it with
``LogWrapped``, naming the oldest seq left.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu_torch.record.audit import InvariantAuditor

DECISION_KINDS = ("scheduler.cycle", "planner.plan", "capacity.observe")


@dataclass
class ReplayReport:
    cycles: int = 0
    plans: int = 0
    capacity_observes: int = 0
    forecast_cycles: int = 0
    forecast_outcomes: int = 0
    timeline_findings: int = 0
    drifts: List[dict] = field(default_factory=list)
    violations: List[dict] = field(default_factory=list)
    skips: List[dict] = field(default_factory=list)
    # host seconds: the whole run and its audits
    seconds: float = field(default=0.0, compare=False)
    audit_seconds: float = field(default=0.0, compare=False)

    def ok(self) -> bool:
        return not self.drifts and not self.violations

    def render(self) -> str:
        lines = [
            f"replayed {self.cycles} scheduler cycle(s), {self.plans} plan(s), "
            f"{self.capacity_observes} capacity observe(s), "
            f"{self.forecast_outcomes} forecast outcome(s), "
            f"{self.timeline_findings} timeline finding(s): "
            f"{len(self.drifts)} drift(s), {len(self.violations)} audit "
            f"violation(s), {len(self.skips)} skip(s)"
        ]
        for drift in self.drifts:
            lines.append(f"  DRIFT seq={drift.get('seq')}: {drift.get('detail')}")
        for violation in self.violations:
            lines.append(f"  AUDIT {violation.get('check')}: {violation.get('detail')}")
        for skip in self.skips:
            lines.append(f"  skip seq={skip.get('seq')}: {skip.get('detail')}")
        return "\n".join(lines)


class LogWrapped(ValueError):
    """The log's ring dropped its oldest records."""


class ReplaySession:
    def __init__(self, records: List[dict]) -> None:
        from nos_tpu_torch.capacity import CapacityLedger
        from nos_tpu_torch.controllers.partitioner import build_sim_framework
        from nos_tpu_torch.controllers.partitioner.node_controller import ensure_pod_indexers
        from nos_tpu_torch.gpu.node import PARTITIONING_MIG, PARTITIONING_MPS
        from nos_tpu_torch.kube.store import NodeStore
        from nos_tpu_torch.partitioning.core import Planner
        from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
        from nos_tpu_torch.partitioning.mps import MpsSnapshotTaker
        from nos_tpu_torch.scheduler.scheduler import Scheduler, new_framework

        if records:
            first = min(records, key=lambda r: r["seq"])
            if first.get("kind") != "session.start" or first["seq"] != 1:
                raise LogWrapped(f"log wrapped at seq {first['seq']}: the ring dropped the "
                                 "session header and the earliest writes")
        self.records = records
        self.meta = next((r for r in records if r.get("kind") == "session.start"), {})
        self._now = float(self.meta.get("wall_time", 0.0))
        self.store = NodeStore(clock=lambda: self._now)
        ensure_pod_indexers(self.store)
        # the store's own total order, not arrival
        self.deltas = sorted((r for r in records if r.get("kind") == "delta"),
                             key=lambda r: (r["revision"], r["seq"]))
        self._delta_index = 0
        # watermark order: a record's sequence would fast-forward the store
        # past a plan's watermark and feed it its own actuation
        self.decisions = sorted((r for r in records if r.get("kind") in DECISION_KINDS),
                                key=lambda r: (r.get("revision", 0), r["seq"]))
        self.forecast_records = sorted(
            (r for r in records if r.get("kind") in ("forecast.cycle", "forecast.outcome")),
            key=lambda r: r["seq"])
        self.timeline_records = sorted(
            (r for r in records if r.get("kind") == "timeline.finding"), key=lambda r: r["seq"])
        framework = new_framework(self.store, self.meta.get("gang_timeout_seconds", 30.0))
        self.scheduler = Scheduler(self.store, framework,
                                   scheduler_name=self.meta.get("scheduler_name", ""))
        aging = self.meta.get("aging_per_second", 1.0)
        self._planners: Dict[str, object] = {}
        for kind in (PARTITIONING_MIG, PARTITIONING_MPS):
            planner = Planner(build_sim_framework(self.store))
            planner.aging_per_second = aging
            self._planners[kind] = planner
        self._takers = {PARTITIONING_MIG: MigSnapshotTaker(), PARTITIONING_MPS: MpsSnapshotTaker()}
        self.auditor = InvariantAuditor(sample_rate=1.0)
        # built before any delta, off the registry, recording nothing
        self.capacity_ledger = CapacityLedger(self.store, metrics=False)

    # ----------------------------------------------------------- state

    def _apply_deltas_up_to(self, revision: int) -> None:
        from nos_tpu_torch.kube import flatwire

        while self._delta_index < len(self.deltas):
            delta = self.deltas[self._delta_index]
            if delta["revision"] > revision:
                return
            self.store.apply_event(delta["type"], flatwire.from_wire(delta["object"]))
            self._delta_index += 1

    # ------------------------------------------------------------- run

    def run(self) -> ReplayReport:
        t0 = time.perf_counter()
        report = ReplayReport()
        for record in self.decisions:
            self._apply_deltas_up_to(record.get("revision", 0))
            self._now = float(record.get("ts", self._now))
            if record["kind"] == "scheduler.cycle":
                self._replay_cycle(record, report)
            elif record["kind"] == "capacity.observe":
                self._replay_capacity(record, report)
            else:
                self._replay_plan(record, report)
        self._replay_forecasts(report)
        self._replay_timeline(report)
        report.seconds = time.perf_counter() - t0
        return report

    def _replay_cycle(self, record: dict, report: ReplayReport) -> None:
        namespace, _, name = record["pod"].partition("/")
        pod = self.store.try_get("Pod", name, namespace)
        if pod is None:
            report.skips.append({"seq": record["seq"], "detail": f"pod {record['pod']} absent "
                                 f"at revision {record.get('revision')}"})
            return
        report.cycles += 1
        outcome = self.scheduler.decide(pod)
        if record.get("settled", True):
            # a cycle whose writes failed is re-decided but not settled:
            # its bind never happened
            self.scheduler.settle(outcome)
        got = {"decision": outcome.decision, "node": outcome.node,
               "bound": sorted([p.namespaced_name, n] for p, n in outcome.to_bind),
               "victims": sorted(outcome.victims)}
        want = {"decision": record["decision"], "node": record.get("node", ""),
                "bound": sorted(list(pair) for pair in record.get("bound", [])),
                "victims": sorted(record.get("victims", []))}
        if got != want:
            report.drifts.append({"seq": record["seq"], "kind": "scheduler.cycle",
                                  "pod": record["pod"],
                                  "detail": f"recorded {want} but replay decided {got}"})

    def _replay_plan(self, record: dict, report: ReplayReport) -> None:
        from nos_tpu_torch.partitioning.core.partition_state import (
            partitioning_state_equal,
            partitioning_state_from_dict,
            partitioning_state_to_dict,
        )
        from nos_tpu_torch.partitioning.core.state import state_from_store

        kind = record.get("partitioner_kind", "")
        planner = self._planners.get(kind)
        if planner is None:
            report.skips.append({"seq": record["seq"],
                                 "detail": f"unknown partitioning mode {kind!r}"})
            return
        pending = []
        for key in record.get("pending", []):
            namespace, _, name = key.partition("/")
            pod = self.store.try_get("Pod", name, namespace, copy=False)
            if pod is not None:
                pending.append(pod)
        report.plans += 1
        snapshot = self._takers[kind].take_snapshot(state_from_store(self.store))
        desired = planner.plan(snapshot, pending, pending_ages=record.get("pending_ages", {}))
        recorded = partitioning_state_from_dict(record.get("desired", {}))
        if not partitioning_state_equal(desired, recorded):
            report.drifts.append({
                "seq": record["seq"], "kind": "planner.plan", "plan_id": record.get("plan_id", ""),
                "detail": (f"recorded desired {record.get('desired')} but replay planned "
                           f"{partitioning_state_to_dict(desired)}")})
        t0 = time.perf_counter()
        violations = self.auditor.audit_plan(planner, snapshot, exhaustive=True,
                                             revision=record.get("revision", 0))
        report.audit_seconds += time.perf_counter() - t0
        report.violations.extend(v.to_dict() for v in violations)

    def _replay_capacity(self, record: dict, report: ReplayReport) -> None:
        """Re-integrate the shadow ledger to the recorded time and demand
        the recorded totals exactly: the integrals are sums of float
        products in a fixed (sorted) order over state the deltas fix."""
        report.capacity_observes += 1
        self.capacity_ledger.observe(record["now"], reason=record.get("reason"), record=False)
        got = self.capacity_ledger.totals()
        want = record.get("totals", {})
        if got != want:
            report.drifts.append({"seq": record["seq"], "kind": "capacity.observe",
                                  "detail": f"recorded totals {want} but replay integrated "
                                            f"{got}"})
        # replay is single-threaded: every observation gets the check
        t0 = time.perf_counter()
        for diff in self.capacity_ledger.self_check(self.store):
            report.violations.append({"check": "capacity_ledger", "subject": "ledger",
                                      "detail": diff})
        report.audit_seconds += time.perf_counter() - t0

    def _replay_forecasts(self, report: ReplayReport) -> None:
        """Re-feed the recorded joins through a fresh tracker (a pure
        function of its ``add`` history) and demand each recorded
        calibration."""
        from nos_tpu_torch.forecast.accuracy import CalibrationTracker

        shadow = CalibrationTracker()
        for record in self.forecast_records:
            if record["kind"] == "forecast.cycle":
                report.forecast_cycles += 1
                continue
            report.forecast_outcomes += 1
            shadow.add(record.get("eta_seconds"), record.get("actual_seconds", 0.0),
                       record.get("wait_seconds", 0.0), stage=record.get("stage", ""))
            got = shadow.payload()
            want = record.get("calibration", {})
            if got != want:
                report.drifts.append({"seq": record["seq"], "kind": "forecast.outcome",
                                      "gang": record.get("gang", ""),
                                      "detail": f"recorded calibration {want} but replay "
                                                f"recomputed {got}"})

    def _replay_timeline(self, report: ReplayReport) -> None:
        """Re-run each finding's detector (a pure function of its window
        and parameters) and demand the recorded verdict."""
        from nos_tpu_torch.timeline.detectors import run_detector

        for record in self.timeline_records:
            report.timeline_findings += 1
            got = run_detector(record["detector"], record.get("window", []),
                               record.get("params", {}))
            want = record.get("verdict")
            if got != want:
                report.drifts.append({"seq": record["seq"], "kind": "timeline.finding",
                                      "series": record.get("series", ""),
                                      "detail": f"recorded verdict {want} but replay "
                                                f"recomputed {got}"})


def replay_file(path: str) -> ReplayReport:
    """Load a JSONL export and replay it."""
    from nos_tpu_torch.record.recorder import load_jsonl

    return ReplaySession(load_jsonl(path)).run()


def drift_exit_code(report: Optional[ReplayReport]) -> int:
    return 0 if report is not None and report.ok() else 1
