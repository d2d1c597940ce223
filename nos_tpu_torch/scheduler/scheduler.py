"""The scheduler: one scheduling cycle per pending pod, polled.

Counterpart of ``nos_tpu/scheduler/scheduler.py``: ``new_framework``
(``:50-79``), ``Scheduler.reconcile`` (``:162-203``), ``decide`` (the
reference's ``_decide``, ``:266-401``), ``_bind`` (``:541``),
``_mark_unschedulable`` (``:574``), ``_set_nominated`` (``:605``) and
``_handle_gang_timeouts`` (``:614-631``). A cycle runs PreFilter → Filter over every node → Score
→ Reserve → Permit → Bind. Every extension point sees the whole cluster
under ``TOPOLOGY_NODE_INFOS_KEY`` (the spread and affinity filters read
it). When the PreFilter refuses the pod, or no node passes the filters,
the PostFilter plugins run (``CapacityScheduling``'s preemption): if one
nominates a node, its victims are gone and the pod's ``nominated_node``
is written (the ``nominate`` outcome, retried next step); else the pod's
PodScheduled=False / Unschedulable condition is set with the diagnosis
as its message, the signal the partitioner batches on (a nominated pod
that fails again loses its nomination, handing it back to the
partitioner), and after a Filter failure ``BoardReservation`` may
reserve a node to drain for it. Permit is ``GangScheduling``'s: a gang
member that is not the last to arrive ``wait``s, its claim on the node
kept in the assume cache (every later cycle's ``NodeInfo`` counts it,
and a waiting member is not cycled again, nor marked unschedulable); the
last arrival binds, and every waiting member of its gang binds with it,
each bind releasing the reservation the pod held. A gang that does not
form within its timeout (the store's clock) is unreserved and marked
unschedulable as a unit.

``reconcile(name, namespace)`` is the reference's reconcile of one pod
(the gang timeouts first, then the cycle); the scheduler component
(``cmd/scheduler.py``) drives it from its watches and maps each outcome
to the reference's requeue. ``SimCluster`` polls: ``step()`` clears the invalid reservations (the
reference's janitor), drops the Permit claims of members gone from the
store or recreated under their name (with their place in the gang's
waiting set, which the reference keeps), forgets the quota reservations
of pods now bound or gone (the reference's guard at ``:166-176``), then
reconciles every pending pod this scheduler owns (highest priority
first, then by namespace and name); ``start()`` runs the steps on a
thread of its own every ``interval`` seconds until ``stop()``, as
``MigAgent`` does. With a ``capacity_ledger`` the cycles stamp the gang
wait clocks on the store's clock, as the reference's do (``:269-273``,
``:437-445``, ``:469-473``, ``:619-624``): a gang's first cycle its
arrival, a member waiting in Permit or binding its first feasible cycle,
its bind the bound stamp, a timeout drops the clock. A failed cycle's
diagnosis is kept, the latest a pod for ``DIAGNOSIS_RECORDS`` pods
(``:135-136``, ``:517-520``): ``explain(pod_key)``, the
``/debug/explain`` backend.

A cycle is ``decide`` (the pipeline above, the reference's ``:251-401``)
then its writes (the bind, the nomination, the Unschedulable condition).
``settle`` is replay's companion of ``decide`` (``:403``): a bind's
in-memory effects without its writes. With an ``EventRecorder``
(``recorder``) a bind records ``Scheduled`` and every failed cycle
``FailedScheduling`` (``:508-515``, ``:566-573``), and the preemptor
``Preempted``. With a ``FlightRecorder`` every cycle writes a
``scheduler.cycle`` record (``:417-437``): the store revision read at
the cycle's entry, the decision, the pods bound, the victims, the
diagnosis, the cycle span's trace id (the port's control plane opens no
pod journey, the reference's root) and whether its writes landed. Every
cycle, recorded or not, takes its watermark, re-reads its pod and runs
``decide`` under one hold of the store (``NodeStore.hold``), so the
decision read exactly the store at its watermark, the state replay
re-decides on; the reference reads them apart, and its threaded
recordings can replay with drift. The cycle's writes come after the
hold. ``preemptions`` keeps the preemptor's records of the last
``PREEMPTION_RECORDS`` preemptions beside the events.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.constants import (
    EVENT_REASON_FAILED_SCHEDULING,
    EVENT_REASON_SCHEDULED,
)
from nos_tpu_torch.kube.store import NodeStore, NotFoundError, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import (
    TOPOLOGY_NODE_INFOS_KEY,
    CycleState,
    Diagnosis,
    Framework,
    NodeInfo,
    PodTopologySpreadScoring,
    Status,
    StatusCode,
    TaintTolerationScoring,
    vanilla_filter_plugins,
)
from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
from nos_tpu_torch.scheduler.plugins.gang import GangScheduling, gang_of
from nos_tpu_torch.scheduler.plugins.reservation import AutoscalerGraceScoring, BoardReservation
from nos_tpu_torch.scheduler.plugins.topology import MultinodeFilter, TopologyScoring
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.scheduler")

PREEMPTION_RECORDS = 1024
# the diagnoses /debug/explain keeps, one a pod, the oldest dropped first
DIAGNOSIS_RECORDS = 1024
GANG_TIMEOUT_MESSAGE = "gang formation timed out"


def new_framework(store: Optional[NodeStore] = None,
                  gang_timeout_seconds: float = 30.0) -> Framework:
    """The default plugin wiring. Without a store: the vanilla predicates
    and the taint score. With the store the quotas and gangs live in, the
    reference's: ``CapacityScheduling`` as PreFilter, PostFilter and
    Reserve (its preemption re-runs this framework's filters), the vanilla
    predicates then ``MultinodeFilter`` and ``BoardReservation``,
    ``GangScheduling`` as Permit, and the topology, taint, spread and
    autoscaler-grace scores (``framework.capacity`` / ``.gang`` /
    ``.reservation``)."""
    if store is None:
        return Framework(filter_plugins=vanilla_filter_plugins(),
                         score_plugins=[TaintTolerationScoring()])
    capacity = CapacityScheduling(store)
    gang = GangScheduling(store, wait_timeout_seconds=gang_timeout_seconds)
    reservation = BoardReservation(store)
    framework = Framework(
        pre_filter_plugins=[capacity],
        filter_plugins=vanilla_filter_plugins() + [MultinodeFilter(store, gang), reservation],
        post_filter_plugins=[capacity], reserve_plugins=[capacity], permit_plugins=[gang],
        score_plugins=[TopologyScoring(store), TaintTolerationScoring(),
                       PodTopologySpreadScoring(), AutoscalerGraceScoring()])
    capacity.framework = framework
    framework.capacity = capacity
    framework.gang = gang
    framework.reservation = reservation
    return framework


class _AssumeCache(dict):
    """The assume cache; every write bumps ``version``."""

    version = 0

    def __setitem__(self, key, value) -> None:
        self.version += 1
        super().__setitem__(key, value)

    def __delitem__(self, key) -> None:
        self.version += 1
        super().__delitem__(key)

    def pop(self, key, *default):
        if key in self:
            self.version += 1
        return super().pop(key, *default)


@dataclass
class CycleOutcome:
    """One cycle's decision, before its store writes."""

    decision: str  # bind | wait | nominate | fail
    node: str = ""
    # a bind's pods and nodes: the pod, and its gang's waiting members
    to_bind: List[Tuple[Pod, str]] = field(default_factory=list)
    victims: List[str] = field(default_factory=list)  # evicted by a nominate
    diagnosis: Optional[Diagnosis] = None
    message: str = ""


class Scheduler:
    def __init__(self, store: NodeStore, framework: Optional[Framework] = None,
                 scheduler_name: str = "", interval: float = 0.5,
                 capacity_ledger=None, recorder=None, flight_recorder=None) -> None:
        self.store = store
        self.capacity_ledger = capacity_ledger
        self.framework = framework or new_framework(store)
        # an EventRecorder: Scheduled on a bind, FailedScheduling on every
        # failed cycle, and through the quota plugin the preemptor's
        # Preempted
        self.recorder = recorder
        # a FlightRecorder: one scheduler.cycle record a cycle
        self.flight_recorder = flight_recorder
        # the plugins new_framework wired (None when absent)
        self.capacity: Optional[CapacityScheduling] = getattr(self.framework, "capacity", None)
        self.gang: Optional[GangScheduling] = getattr(self.framework, "gang", None)
        self.reservation: Optional[BoardReservation] = getattr(self.framework, "reservation",
                                                               None)
        if self.capacity is not None and recorder is not None:
            self.capacity.recorder = recorder
        # the preemptor's records of the last PREEMPTION_RECORDS
        # preemptions (the invariants read them)
        self.preemptions: Deque[dict] = deque(maxlen=PREEMPTION_RECORDS)
        # pod key → its latest failed cycle's diagnosis (``explain``)
        self._diagnoses: Dict[str, dict] = {}
        self._diagnoses_lock = threading.Lock()
        # the assume cache: pod key → (pod, node) of gang members waiting
        # in Permit, reserved on a node but not bound
        self._assumed: Dict[str, Tuple[Pod, str]] = _AssumeCache()
        # (store revision, assume-cache version, the cycle's node views)
        self._infos_memo: Optional[tuple] = None
        # gang key → the times its formation timed out
        self.gang_timeouts: Dict[str, int] = {}
        # non-empty: only pods naming this scheduler are ours
        self.scheduler_name = scheduler_name
        self.interval = interval
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def responsible_for(self, pod: Pod) -> bool:
        return not self.scheduler_name or pod.scheduler_name == self.scheduler_name

    def assumed(self) -> Dict[str, str]:
        """Pod key → node of every gang member waiting in Permit."""
        return {key: node for key, (_, node) in self._assumed.items()}

    # ------------------------------------------------------------ cycle

    def step(self) -> int:
        """Reconcile every pending unbound pod of ours; the pods bound."""
        if self.reservation is not None:
            self.reservation.release_invalid()
        pods = self.store.list("Pod", copy=False)
        self._forget_gone_assumed(pods)
        if self.capacity is not None:
            self._forget_settled(pods)
        pending = [p for p in pods
                   if p.phase == PodPhase.PENDING and not p.node and self.responsible_for(p)]
        pending.sort(key=lambda p: (-p.priority, p.namespace, p.name))
        bound = 0
        for pod in pending:
            outcome = self.reconcile(pod.name, pod.namespace)
            if outcome is not None and outcome.decision == "bind":
                bound += len(outcome.to_bind)
        return bound

    def _forget_gone_assumed(self, pods: List[Pod]) -> None:
        """Drop the Permit claims of members deleted, or recreated under
        their name, since they waited: the reference's delete event pops
        them, and no poll of a pending pod reaches a pod that is gone."""
        live = {p.namespaced_name: p.uid for p in pods}
        for key, (pod, _) in list(self._assumed.items()):
            if live.get(key) != pod.uid:
                self._drop_assumed(key)

    def _drop_assumed(self, key: str) -> None:
        self._assumed.pop(key, None)
        if self.gang is not None:
            self.gang.forget(key)

    def _forget_settled(self, pods: List[Pod]) -> None:
        """Drop the reservations of pods now bound, finished or gone: the
        store counts them from here on, or nothing should."""
        live = {p.namespaced_name: p for p in pods}
        for key in self.capacity.reserved_keys():
            pod = live.get(key)
            if pod is None or pod.node or pod.phase != PodPhase.PENDING:
                self.capacity.forget_key(key)

    def reconcile(self, name: str, namespace: str) -> Optional[CycleOutcome]:
        """The reference's reconcile of one pod: the gang timeouts, then a
        cycle unless the pod is gone, bound, finished, another scheduler's
        or waiting in Permit (None then)."""
        self.handle_gang_timeouts()
        key = f"{namespace}/{name}"
        pod = self.store.try_get("Pod", name, namespace, copy=False)
        if pod is None:
            # gone: its claims die with it
            self._drop_assumed(key)
            if self.capacity is not None:
                self.capacity.forget_key(key)
            return None
        if not self.responsible_for(pod):
            return None
        if pod.node or pod.phase != PodPhase.PENDING:
            if self.capacity is not None:
                self.capacity.forget_key(key)
            return None
        if key in self._assumed:
            if self._assumed[key][0].uid == pod.uid:
                # a member validly waiting in Permit: a cycle would see its
                # own claim and mark it unschedulable
                return None
            self._drop_assumed(key)  # recreated under its name
        return self.schedule_one(pod)

    def _gang_clock(self, pod: Pod, stamp: str) -> None:
        """Stamp the pod's gang wait clock on the capacity ledger."""
        gang = gang_of(pod) if self.capacity_ledger is not None else None
        if gang is not None:
            getattr(self.capacity_ledger, stamp)(gang[0], self.store.clock())

    def schedule_one(self, pod: Pod) -> CycleOutcome:
        with TRACER.span("scheduler.cycle", pod=pod.namespaced_name) as span:
            # idempotent: the first cycle of any member starts the clock
            self._gang_clock(pod, "note_gang_arrival")
            # the watermark and the reads under one hold of the store: a
            # replay at the watermark sees what this cycle read
            with self.store.hold():
                revision = self.store.revision
                current = self.store.try_get("Pod", pod.name, pod.namespace, copy=False)
                if current is not None and current.uid == pod.uid:
                    pod = current  # the pod as it stands at the watermark
                outcome = self.decide(pod)
            span.set_attributes(decision=outcome.decision, node=outcome.node)
            try:
                self._apply_outcome(pod, outcome, span)
            except Exception:
                # the decision's in-memory effects happened; its writes did
                # not: replay re-decides it and skips settle
                self._record_cycle(pod, revision, outcome, span, settled=False)
                raise
            self._record_cycle(pod, revision, outcome, span)
        return outcome

    def settle(self, outcome: CycleOutcome) -> None:
        """Replay's companion of ``decide``: a bind's in-memory effects (the
        assume cache, the quota reservations) without its writes, which
        come as recorded deltas."""
        if outcome.decision != "bind":
            return
        for bind_pod, _ in outcome.to_bind:
            self._assumed.pop(bind_pod.namespaced_name, None)
            if self.capacity is not None:
                self.capacity.forget(bind_pod)

    def _apply_outcome(self, pod: Pod, outcome: CycleOutcome, span) -> None:
        """The outcome's writes, events and clocks."""
        if outcome.decision in ("wait", "bind"):
            # the whole gang found nodes this cycle
            self._gang_clock(pod, "note_gang_feasible")
        if outcome.decision == "bind":
            span.set_attributes(pods=len(outcome.to_bind))
            for bind_pod, node_name in outcome.to_bind:
                self._assumed.pop(bind_pod.namespaced_name, None)
                self._bind(bind_pod, node_name)
                if self.reservation is not None:
                    self.reservation.release_for(bind_pod)
            for bind_pod, _ in outcome.to_bind:
                self._gang_clock(bind_pod, "note_gang_bound")
        elif outcome.decision == "wait":
            log.info("scheduler: %s waiting (%s)", pod.namespaced_name, outcome.message)
        elif outcome.decision == "nominate":
            span.set_attributes(victims=len(outcome.victims))
            self._set_nominated(pod, outcome.node)
        else:
            self._note_diagnosis(pod, outcome.diagnosis)
            if self.recorder is not None:
                # every failed cycle: a repeat bumps the event's count
                self.recorder.record(pod, EVENT_REASON_FAILED_SCHEDULING, outcome.message,
                                     type="Warning")
            self._mark_unschedulable(pod, outcome.message)

    def _record_cycle(self, pod: Pod, revision: int, outcome: CycleOutcome, span,
                      settled: bool = True) -> None:
        if self.flight_recorder is None:
            return
        diagnosis = outcome.diagnosis
        self.flight_recorder.record_scheduler_cycle(
            pod=pod.namespaced_name, revision=revision, decision=outcome.decision,
            node=outcome.node, bound=[[p.namespaced_name, n] for p, n in outcome.to_bind],
            victims=list(outcome.victims), message=outcome.message,
            trace_id=span.trace_id,
            diagnosis=(diagnosis.to_dict(timestamp=self.store.clock())
                       if diagnosis is not None else None),
            settled=settled)

    def _note_diagnosis(self, pod: Pod, diagnosis: Optional[Diagnosis]) -> None:
        if diagnosis is None:
            return
        doc = diagnosis.to_dict(timestamp=self.store.clock())
        with self._diagnoses_lock:
            self._diagnoses.pop(pod.namespaced_name, None)
            while len(self._diagnoses) >= DIAGNOSIS_RECORDS:
                self._diagnoses.pop(next(iter(self._diagnoses)))
            self._diagnoses[pod.namespaced_name] = doc

    def explain(self, pod_key: str) -> Optional[dict]:
        """The latest diagnosis of ``namespace/name``, or None: the
        ``/debug/explain`` backend."""
        with self._diagnoses_lock:
            return self._diagnoses.get(pod_key)

    def _post_filter(self, state: CycleState, pod: Pod,
                     filtered: Dict[str, Status]) -> Optional[CycleOutcome]:
        """PostFilter after a PreFilter or Filter rejection: the
        nomination, or None."""
        nominated = self.framework.run_post_filter_plugins(state, pod, filtered)
        if not nominated:
            return None
        record = getattr(self.capacity, "last_preemption", None)
        if record is not None:
            self.preemptions.append(record)
        victims = [v["pod"] for v in record["victims"]] if record else []
        return CycleOutcome("nominate", node=nominated, victims=victims)

    def _fail(self, pod: Pod, node_infos: Dict[str, NodeInfo],
              filtered: Dict[str, Status]) -> CycleOutcome:
        diagnosis = self._diagnosis(pod, node_infos, filtered)
        return CycleOutcome("fail", diagnosis=diagnosis, message=diagnosis.aggregate_message())

    def decide(self, pod: Pod) -> CycleOutcome:
        """The cycle's decision, without its bind, nomination and
        unschedulable writes: replay's entry point. The in-memory
        bookkeeping (the assume cache, the gangs, the quota reservations)
        moves as in a live cycle, and the preemption's evictions and the
        drain reservation still write (they converge with the recorded
        deltas)."""
        if self.capacity is not None:
            self.capacity.last_preemption = None
        state = CycleState()
        node_infos = self._node_infos()
        # published before any extension point: the PreFilter-failure
        # preemption runs filters too
        state[TOPOLOGY_NODE_INFOS_KEY] = list(node_infos.values())
        status = self.framework.run_pre_filter_plugins(state, pod)
        if not status.success:
            # a quota refusal still gets a preemption attempt: evictions
            # may change the quota arithmetic
            filtered = {name: status for name in node_infos}
            return (self._post_filter(state, pod, filtered)
                    or self._fail(pod, node_infos, filtered))
        feasible: List[NodeInfo] = []
        filtered: Dict[str, Status] = {}
        for info in node_infos.values():
            node_status = self.framework.run_filter_plugins(state, pod, info)
            if node_status.success:
                feasible.append(info)
            else:
                filtered[info.name] = node_status
        if not feasible:
            nominated = self._post_filter(state, pod, filtered)
            if nominated is not None:
                return nominated
            if self.reservation is not None:
                # a whole-GPU pod blocked by fragmentation: drain the node
                # closest to free (a no-op for anything smaller)
                self.reservation.try_reserve(pod, node_infos)
            return self._fail(pod, node_infos, filtered)
        best = max(feasible, key=lambda info: (
            self.framework.run_score_plugins(state, pod, info), info.name))
        status = self.framework.run_reserve_plugins(state, pod, best.name)
        if not status.success:
            return self._fail(pod, node_infos, {best.name: status})
        permit = self.framework.run_permit_plugins(state, pod, best.name)
        if permit.code == StatusCode.WAIT:
            # the gang is forming: the claim holds and later cycles see it
            self._assumed[pod.namespaced_name] = (pod, best.name)
            return CycleOutcome("wait", node=best.name, message=permit.message)
        if not permit.success:
            self.framework.run_unreserve_plugins(state, pod, best.name)
            return self._fail(pod, node_infos, {best.name: permit})
        to_bind = [(pod, best.name)]
        if self.gang is not None:
            released = self.gang.release(pod)
            if released:
                to_bind = released
                if all(p.namespaced_name != pod.namespaced_name for p, _ in released):
                    to_bind.append((pod, best.name))
        return CycleOutcome("bind", node=best.name, to_bind=to_bind)

    @staticmethod
    def _diagnosis(pod: Pod, node_infos: Dict[str, NodeInfo],
                   filtered: Dict[str, Status]) -> Diagnosis:
        return Diagnosis(pod=pod.namespaced_name, num_nodes=len(node_infos),
                         node_statuses=dict(filtered))

    def _node_infos(self) -> Dict[str, NodeInfo]:
        """Every node with its bound live pods and the Permit claims:
        read-only views (no filter changes a node or a pod), memoized on
        the store's revision and the assume cache's version."""
        key = (self.store.revision, self._assumed.version)
        if self._infos_memo is not None and self._infos_memo[:2] == key:
            return self._infos_memo[2]
        by_node = self.store.pods_by_node()
        infos = {node.name: NodeInfo(node=node, pods=list(by_node.get(node.name, ())))
                 for node in self.store.list("Node", copy=False)}
        for pod_key, (assumed_pod, node_name) in self._assumed.items():
            if node_name in infos and all(p.namespaced_name != pod_key
                                          for p in infos[node_name].pods):
                infos[node_name].add_pod(assumed_pod)
        self._infos_memo = key + (infos,)
        return infos

    def handle_gang_timeouts(self) -> int:
        """Unreserve and mark unschedulable, as a unit, every gang whose
        formation timed out; the members handed back."""
        if self.gang is None:
            return 0
        released = 0
        for members in self.gang.expired_gangs():
            key = gang_of(members[0][0])[0]
            self.gang_timeouts[key] = self.gang_timeouts.get(key, 0) + 1
            if self.capacity_ledger is not None:
                # the gang will not bind: a stale clock would pollute its
                # re-arrival's wait
                self.capacity_ledger.drop_gang(key)
            for member, node_name in members:
                self._assumed.pop(member.namespaced_name, None)
                self.framework.run_unreserve_plugins(CycleState(), member, node_name)
                self._mark_unschedulable(member, GANG_TIMEOUT_MESSAGE)
                released += 1
                log.info("scheduler: gang timeout, released %s", member.namespaced_name)
        return released

    # ----------------------------------------------------------- writes

    def _bind(self, pod: Pod, node_name: str) -> None:
        def mutate(p: Pod) -> None:
            p.node = node_name
            p.nominated_node = ""
            p.unschedulable = False
            p.unschedulable_message = ""

        try:
            self.store.patch_merge("Pod", pod.name, pod.namespace, mutate)
        except NotFoundError:
            return
        if self.recorder is not None:
            self.recorder.record(pod, EVENT_REASON_SCHEDULED,
                                 f"Successfully assigned {pod.namespaced_name} to {node_name}")
        log.info("scheduler: bound %s to %s", pod.namespaced_name, node_name)

    def _mark_unschedulable(self, pod: Pod, message: str) -> None:
        # a nominated pod failing again needs more than its victims' room
        # (on a MIG node, a re-carve the partitioner skips for preempting
        # pods): clearing the nomination hands it back to the partitioner
        clear_nomination = bool(pod.nominated_node)
        if pod.unschedulable and not clear_nomination:
            return  # already marked; no patch churn

        def mutate(p: Pod) -> None:
            p.nominated_node = ""
            p.unschedulable = True
            p.unschedulable_message = message

        try:
            self.store.patch_merge("Pod", pod.name, pod.namespace, mutate)
        except NotFoundError:
            pass

    def _set_nominated(self, pod: Pod, node_name: str) -> None:
        try:
            self.store.patch_merge("Pod", pod.name, pod.namespace,
                                   lambda p: setattr(p, "nominated_node", node_name))
        except NotFoundError:
            pass

    # -------------------------------------------------------- lifecycle

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:  # the loop goes on; the caller reads .error
                log.exception("scheduler step failed")
                self.error = e
            self._stop.wait(self.interval)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
