"""InvariantAuditor: recompute the incremental planning structures'
ground truth and compare.

Counterpart of ``nos_tpu/record/audit.py``. The planner is fast because
it is incremental: the snapshot keeps its free pool by delta, the
verdict cache memoizes plugin verdicts by (pod signature, node,
version), the slice tracker keeps its lacking totals by subtraction and
the carve-futility memo skips whole fork-and-carve trials. Each claims
to equal an exact truth; the auditor recomputes it, so silent drift
becomes a counted, evented, recorded violation instead of a wrong plan.

The checks (``CHECKS``), on the port's structures:

- ``verdict_cache``: each entry of ``Planner._verdict_cache`` keyed at
  its node's current version against a fresh run of the cacheable
  plugins on a fresh view of the node (the entry's pod comes from
  ``Planner._signature_cache``);
- ``lacking_totals``: ``SliceTracker``'s kept totals (``_totals``, once
  computed) against a re-sum over its lacking map (the port's tracker
  keeps one total, where the reference keeps one an accelerator; the
  subject is ``slices``);
- ``free_pool``: the snapshot's kept free pool against
  ``_compute_free_pool()``;
- ``mutation_clock``: no node's version past ``state_version``, and no
  two nodes on one nonzero tick;
- ``carve_futility``: each ``_futility_cache`` entry keyed at its node's
  current version against a real carve on a fork (reverted);
- ``incremental_plan``: a plan that ran ``incremental`` against a plan
  from scratch of the same pending pods on a fresh clone of the base,
  with the recorded ages; a disagreement counts only when a second
  shadow agrees with the first (else the inputs moved under it);
- ``capacity_ledger``: the ledger's ``self_check`` (the incremental
  state against a recomputation from the store; silent while writers
  hold the store past its watermark).

Live, the controller audits a sample of its plans (``should_audit``: a
counter stride, no RNG, so a replay samples the plans the live run did)
and caps the per-entry checks at ``max_entries_per_check``; replay
audits every plan exhaustively. ``audit_sharded_plan`` runs the pool
checks pool by pool (subjects prefixed ``pool=<id>/``). A pool planned
on a worker process is audited behind its parent-side planner
(``Planner.memos_remote``), whose memos are empty: its ``verdict_cache``
and ``carve_futility`` checks are counted in ``checks_skipped``, not
run. ``audits_run`` counts the audits made (``audit_plan`` and
``audit_sharded_plan`` calls). ``publish``
counts each violation in ``nos_tpu_audit_violations_total{check}``,
records an ``AuditViolation`` event about a node-scoped one's node and
writes an ``audit`` flight record.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import resources as res

CHECKS = (
    "verdict_cache",
    "lacking_totals",
    "free_pool",
    "mutation_clock",
    "carve_futility",
    "incremental_plan",
    "capacity_ledger",
)


def _nonzero(pool: Dict[str, int]) -> Dict[str, int]:
    """A zero entry is representation (a drained counter kept or popped),
    not drift."""
    return {k: v for k, v in pool.items() if v}


@dataclass
class AuditViolation:
    check: str
    subject: str  # a node, a resource, a cache key or a pool's
    detail: str
    node: str = ""  # set when node-scoped: the event's target

    def to_dict(self) -> dict:
        return {"check": self.check, "subject": self.subject, "detail": self.detail,
                "node": self.node}


class InvariantAuditor:
    def __init__(self, sample_rate: float = 0.0, recorder=None, flight_recorder=None,
                 max_entries_per_check: int = 8) -> None:
        # the share of plans audited live, by counter stride
        self.sample_rate = sample_rate
        self.recorder = recorder  # an EventRecorder: AuditViolation events
        self.flight_recorder = flight_recorder
        # the live cap on the per-entry checks; exhaustive audits ignore it
        self.max_entries_per_check = max_entries_per_check
        self._plans_seen = 0
        self.violations_total = 0
        self.audits_run = 0
        # check → the pools whose check could not run (memos on a worker)
        self.checks_skipped: Dict[str, int] = {}

    # -------------------------------------------------------- sampling

    def should_audit(self) -> bool:
        """Plan k is audited iff floor(k * rate) advances: exactly ``rate``
        of the plans, with no RNG."""
        if self.sample_rate <= 0:
            return False
        self._plans_seen += 1
        k = self._plans_seen
        return math.floor(k * self.sample_rate) > math.floor((k - 1) * self.sample_rate)

    # ----------------------------------------------------------- entry

    def audit_plan(self, planner, snapshot, exhaustive: bool = False, revision: int = 0,
                   pending=None, desired=None, ledger=None) -> List[AuditViolation]:
        """Every check against the planner's last plan; published and
        returned. Without ``pending`` / ``desired`` (replay, a structural
        audit) the incremental-plan check idles."""
        self.audits_run += 1
        violations = self._pool_checks(planner, snapshot, exhaustive, pending, desired)
        violations += self.check_capacity_ledger(ledger)
        self.publish(violations, snapshot, revision)
        return violations

    def audit_sharded_plan(self, pool_runs, snapshot=None, exhaustive: bool = False,
                           revision: int = 0, ledger=None) -> List[AuditViolation]:
        """``audit_plan`` pool by pool: ``pool_runs`` holds (pool, planner,
        pool snapshot, pending, desired); each violation's subject is
        prefixed with its pool. ``snapshot`` (the unsharded base) only
        targets events; the ledger check stays cluster-wide."""
        self.audits_run += 1
        violations: List[AuditViolation] = []
        for pool, planner, pool_snapshot, pending, desired in pool_runs:
            found = self._pool_checks(planner, pool_snapshot, exhaustive, pending, desired)
            for violation in found:
                violation.subject = f"pool={pool}/{violation.subject}"
            violations += found
        violations += self.check_capacity_ledger(ledger)
        self.publish(violations, snapshot, revision)
        return violations

    def _pool_checks(self, planner, snapshot, exhaustive, pending, desired
                     ) -> List[AuditViolation]:
        out = (self.check_free_pool(snapshot) + self.check_mutation_clock(snapshot)
               + self.check_lacking_totals(getattr(planner, "last_tracker", None)))
        if getattr(planner, "memos_remote", False):
            for check in ("verdict_cache", "carve_futility"):
                self.checks_skipped[check] = self.checks_skipped.get(check, 0) + 1
        else:
            out += (self.check_verdict_cache(planner, snapshot, exhaustive)
                    + self.check_carve_futility(planner, snapshot, exhaustive))
        return out + self.check_incremental_plan(planner, snapshot, pending, desired)

    def publish(self, violations: List[AuditViolation], snapshot=None,
                revision: int = 0) -> None:
        for violation in violations:
            metrics.AUDIT_VIOLATIONS.labels(check=violation.check).inc()
            self.violations_total += 1
            self._emit_event(violation, snapshot)
        if self.flight_recorder is not None and violations:
            self.flight_recorder.record_audit(revision=revision,
                                              violations=[v.to_dict() for v in violations])

    def _emit_event(self, violation: AuditViolation, snapshot) -> None:
        if self.recorder is None or snapshot is None or not violation.node:
            return
        snap_node = snapshot.get_nodes().get(violation.node)
        if snap_node is None or snap_node.node is None:
            return
        from nos_tpu_torch.api.v1alpha1.constants import EVENT_REASON_AUDIT_VIOLATION

        self.recorder.record(snap_node.node, EVENT_REASON_AUDIT_VIOLATION,
                             f"{violation.check}: {violation.detail}", type="Warning")

    # ---------------------------------------------------------- checks

    def check_free_pool(self, snapshot) -> List[AuditViolation]:
        kept = _nonzero(snapshot.free_slice_resources())
        truth = _nonzero(snapshot._compute_free_pool())
        if kept == truth:
            return []
        return [AuditViolation("free_pool", "cluster",
                               f"incremental pool {kept} != recomputed {truth}")]

    def check_mutation_clock(self, snapshot) -> List[AuditViolation]:
        out: List[AuditViolation] = []
        versions = {name: node.version for name, node in snapshot.get_nodes().items()}
        for name, version in versions.items():
            if version > snapshot.state_version:
                out.append(AuditViolation(
                    "mutation_clock", name,
                    f"node version {version} ahead of state_version {snapshot.state_version}",
                    node=name))
        nonzero = [v for v in versions.values() if v]
        if len(nonzero) != len(set(nonzero)):
            dupes = sorted(v for v in set(nonzero) if nonzero.count(v) > 1)
            out.append(AuditViolation("mutation_clock", "cluster",
                                      f"duplicate mutation ticks across nodes: {dupes}"))
        return out

    def check_lacking_totals(self, tracker) -> List[AuditViolation]:
        if tracker is None or tracker._totals is None:
            return []
        truth: res.ResourceList = {}
        for lacking in tracker._lacking.values():
            truth = res.sum_resources(truth, lacking)
        kept = _nonzero(dict(tracker._totals))
        if kept == _nonzero(truth):
            return []
        return [AuditViolation("lacking_totals", "slices",
                               f"incremental totals {kept} != recomputed {_nonzero(truth)}")]

    def check_verdict_cache(self, planner, snapshot, exhaustive: bool = False
                            ) -> List[AuditViolation]:
        entries = getattr(planner._verdict_cache, "entries", None)
        if not entries:
            return []
        # a signature alone cannot be re-run: its pod, from the plan's memo
        pod_by_signature = {sig: pod for pod, sig in planner._signature_cache.values()}
        nodes = snapshot.get_nodes()
        out: List[AuditViolation] = []
        checked = 0
        limit = None if exhaustive else self.max_entries_per_check
        for (signature, node_name, version), verdict in list(entries.items()):
            node = nodes.get(node_name)
            if node is None or node.version != version:
                continue  # a stale key: no trial consults it for this state
            pod = pod_by_signature.get(signature)
            if pod is None:
                continue
            fresh = self._fresh_verdict(planner, node, pod)
            if fresh != verdict:
                out.append(AuditViolation(
                    "verdict_cache", f"{node_name}@v{version}",
                    f"cached verdict {verdict} != fresh plugin run {fresh} for "
                    f"{pod.namespaced_name}'s signature on {node_name}", node=node_name))
            checked += 1
            if limit is not None and checked >= limit:
                break
        return out

    @staticmethod
    def _fresh_verdict(planner, node, pod) -> bool:
        """The cacheable plugins on a view of the node built now, past the
        planner's node-view memo."""
        from nos_tpu_torch.scheduler.framework import CycleState

        framework = planner.framework
        state = CycleState()
        status = framework.run_pre_filter_plugins(state, pod, plugins=planner._cacheable_pre)
        if not status.success:
            return False
        return framework.run_filter_plugins(state, pod, node.sim_node_info(),
                                            plugins=planner._cacheable_filters).success

    def check_carve_futility(self, planner, snapshot, exhaustive: bool = False
                             ) -> List[AuditViolation]:
        memo = getattr(planner, "_futility_cache", None)
        if not memo:
            return []
        nodes = snapshot.get_nodes()
        out: List[AuditViolation] = []
        checked = 0
        limit = None if exhaustive else self.max_entries_per_check
        for node_name, version, lacking_items in list(memo):
            node = nodes.get(node_name)
            if node is None or node.version != version:
                continue
            snapshot.fork()
            try:
                changed = snapshot.update_geometry_for(node_name, dict(lacking_items))
            finally:
                snapshot.revert()
            if changed:
                out.append(AuditViolation(
                    "carve_futility", f"{node_name}@v{version}",
                    f"the futility memo holds carving toward {dict(lacking_items)} a no-op, "
                    "but a real carve changed the geometry", node=node_name))
            checked += 1
            if limit is not None and checked >= limit:
                break
        return out

    def check_incremental_plan(self, planner, snapshot, pending, desired
                               ) -> List[AuditViolation]:
        """A plan that ran incremental against a from-scratch shadow plan
        of the same pending pods on a fresh clone of the base, with the
        plan's ages. A disagreement is arbitrated by a second shadow: two
        shadows that agree with each other and not with the plan are
        drift; two that disagree read inputs that moved (the plugins read
        the live store), which is inconclusive."""
        if desired is None or pending is None:
            return []
        if getattr(planner, "last_plan_mode", "full") != "incremental":
            return []
        from nos_tpu_torch.partitioning.core.partition_state import (
            partitioning_state_equal,
            partitioning_state_to_dict,
        )

        first, first_unserved = self._shadow_plan(planner, snapshot, pending)
        desired_ok = partitioning_state_equal(desired, first)
        unserved_ok = dict(planner.last_unserved) == first_unserved
        if desired_ok and unserved_ok:
            return []
        second, second_unserved = self._shadow_plan(planner, snapshot, pending)
        if not partitioning_state_equal(first, second) or first_unserved != second_unserved:
            return []
        out: List[AuditViolation] = []
        if not desired_ok:
            out.append(AuditViolation(
                "incremental_plan", "desired",
                f"incremental desired state {partitioning_state_to_dict(desired)} != "
                f"from-scratch {partitioning_state_to_dict(first)}"))
        if not unserved_ok:
            out.append(AuditViolation(
                "incremental_plan", "unserved",
                f"incremental unserved {dict(planner.last_unserved)} != from-scratch "
                f"{first_unserved}"))
        return out

    def check_capacity_ledger(self, ledger) -> List[AuditViolation]:
        if ledger is None:
            return []
        return [AuditViolation("capacity_ledger", "ledger", diff) for diff in ledger.self_check()]

    @staticmethod
    def _shadow_plan(planner, snapshot, pending):
        """One plan from scratch on a fresh clone of the base: the clones'
        versions restart at 0, as a fresh snapshot's do."""
        from nos_tpu_torch.partitioning.core.planner import Planner
        from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot

        nodes = {}
        for name, node in snapshot.get_nodes().items():
            clone = node.plan_clone()
            clone.version = 0
            nodes[name] = clone
        shadow = Planner(planner.framework, verdict_cache_enabled=planner.verdict_cache_enabled,
                         clock=planner.clock, futility_memo_enabled=planner.futility_memo_enabled,
                         incremental_dirty_threshold=planner.incremental_dirty_threshold)
        shadow.aging_per_second = planner.aging_per_second
        desired = shadow.plan(ClusterSnapshot(nodes, codec=snapshot.codec), list(pending),
                              pending_ages=dict(planner.last_pending_ages))
        return desired, dict(shadow.last_unserved)


def build_auditor(sample_rate: float = 0.0, recorder=None,
                  flight_recorder=None) -> Optional[InvariantAuditor]:
    """The config's seam: a zero rate builds no auditor at all."""
    if sample_rate <= 0:
        return None
    return InvariantAuditor(sample_rate=sample_rate, recorder=recorder,
                            flight_recorder=flight_recorder)
