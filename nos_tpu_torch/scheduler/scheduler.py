"""The scheduler: one scheduling cycle per pending pod, polled.

Counterpart of ``nos_tpu/scheduler/scheduler.py``: ``new_framework``
(``:50``), ``Scheduler.schedule_one`` / ``_decide`` (``:207-402``),
``_bind`` (``:541``), ``_mark_unschedulable`` (``:574``) and
``_set_nominated`` (``:605``). A cycle runs PreFilter → Filter over every
node → Score → Reserve → Bind. When the PreFilter refuses the pod, or
no node passes the filters, the PostFilter plugins run
(``CapacityScheduling``'s preemption, ``:280-340``): if one nominates a
node, its victims are gone and the pod's ``nominated_node`` is written
(the ``nominate`` outcome, retried next step); else the pod's
PodScheduled=False / Unschedulable condition is set with the diagnosis
as its message, the signal the partitioner batches on (a nominated pod
that fails again loses its nomination, handing it back to the
partitioner). The port has no controller manager and no watches:
``step()`` first forgets the quota reservations of pods now bound or
gone from the store (the reference's guard at ``:166-176``), then runs
a cycle for every pending pod this scheduler owns (highest priority
first, then by namespace and name); ``start()`` runs the steps on a
thread of its own every ``interval`` seconds until ``stop()``, as
``MigAgent`` does. Permit and gangs wait for the gang slice (ROADMAP.md).
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from nos_tpu_torch.kube.store import NodeStore, NotFoundError, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import (
    CycleState,
    Diagnosis,
    Framework,
    NodeInfo,
    Status,
    TaintTolerationScoring,
    vanilla_filter_plugins,
)
from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.scheduler")

PREEMPTION_RECORDS = 1024


def new_framework(store: Optional[NodeStore] = None) -> Framework:
    """The default plugin wiring: the vanilla predicates and the taint
    score, and, given the store the quotas live in, ``CapacityScheduling``
    as PreFilter, PostFilter and Reserve (``framework.capacity``; its
    preemption re-runs this framework's filters)."""
    if store is None:
        return Framework(filter_plugins=vanilla_filter_plugins(),
                         score_plugins=[TaintTolerationScoring()])
    capacity = CapacityScheduling(store)
    framework = Framework(pre_filter_plugins=[capacity], filter_plugins=vanilla_filter_plugins(),
                          post_filter_plugins=[capacity], reserve_plugins=[capacity],
                          score_plugins=[TaintTolerationScoring()])
    capacity.framework = framework
    framework.capacity = capacity
    return framework


@dataclass
class CycleOutcome:
    """One cycle's decision, before its store write."""

    decision: str  # bind | nominate | fail
    node: str = ""
    victims: List[str] = field(default_factory=list)  # evicted by a nominate
    diagnosis: Optional[Diagnosis] = None
    message: str = ""


class Scheduler:
    def __init__(self, store: NodeStore, framework: Optional[Framework] = None,
                 scheduler_name: str = "", interval: float = 0.5) -> None:
        self.store = store
        self.framework = framework or new_framework(store)
        # the quota plugin new_framework wired, whose reservations step()
        # forgets
        self.capacity: Optional[CapacityScheduling] = getattr(self.framework, "capacity", None)
        # the preemptor's records of the last PREEMPTION_RECORDS
        # preemptions, in place of the flight recorder
        self.preemptions: Deque[dict] = deque(maxlen=PREEMPTION_RECORDS)
        # non-empty: only pods naming this scheduler are ours
        self.scheduler_name = scheduler_name
        self.interval = interval
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def responsible_for(self, pod: Pod) -> bool:
        return not self.scheduler_name or pod.scheduler_name == self.scheduler_name

    # ------------------------------------------------------------ cycle

    def step(self) -> int:
        """A cycle for every pending unbound pod of ours; the pods bound."""
        pods = self.store.list("Pod", copy=False)
        if self.capacity is not None:
            self._forget_settled(pods)
        pending = [p for p in pods
                   if p.phase == PodPhase.PENDING and not p.node and self.responsible_for(p)]
        pending.sort(key=lambda p: (-p.priority, p.namespace, p.name))
        bound = 0
        for pod in pending:
            bound += self.schedule_one(pod).decision == "bind"
        return bound

    def _forget_settled(self, pods: List[Pod]) -> None:
        """Drop the reservations of pods now bound, finished or gone: the
        store counts them from here on, or nothing should."""
        live = {p.namespaced_name: p for p in pods}
        for key in self.capacity.reserved_keys():
            pod = live.get(key)
            if pod is None or pod.node or pod.phase != PodPhase.PENDING:
                self.capacity.forget_key(key)

    def schedule_one(self, pod: Pod) -> CycleOutcome:
        with TRACER.span("scheduler.cycle", pod=pod.namespaced_name) as span:
            outcome = self._decide(pod)
            span.set_attributes(decision=outcome.decision, node=outcome.node)
            if outcome.decision == "bind":
                self._bind(pod, outcome.node)
            elif outcome.decision == "nominate":
                span.set_attributes(victims=len(outcome.victims))
                self._set_nominated(pod, outcome.node)
            else:
                self._mark_unschedulable(pod, outcome.message)
        return outcome

    def _post_filter(self, state: CycleState, pod: Pod, node_infos: Dict[str, NodeInfo],
                     filtered: Dict[str, Status]) -> CycleOutcome:
        """PostFilter after a PreFilter or Filter rejection: a nomination,
        or the failure with its diagnosis."""
        nominated = self.framework.run_post_filter_plugins(state, pod, filtered)
        if nominated:
            record = getattr(self.capacity, "last_preemption", None)
            if record is not None:
                self.preemptions.append(record)
            victims = [v["pod"] for v in record["victims"]] if record else []
            return CycleOutcome("nominate", node=nominated, victims=victims)
        diagnosis = self._diagnosis(pod, node_infos, filtered)
        return CycleOutcome("fail", diagnosis=diagnosis, message=diagnosis.aggregate_message())

    def _decide(self, pod: Pod) -> CycleOutcome:
        if self.capacity is not None:
            self.capacity.last_preemption = None
        state = CycleState()
        node_infos = self._node_infos()
        status = self.framework.run_pre_filter_plugins(state, pod)
        if not status.success:
            # a quota refusal still gets a preemption attempt: evictions
            # may change the quota arithmetic
            return self._post_filter(state, pod, node_infos,
                                     {name: status for name in node_infos})
        feasible: List[NodeInfo] = []
        filtered: Dict[str, Status] = {}
        for info in node_infos.values():
            node_status = self.framework.run_filter_plugins(state, pod, info)
            if node_status.success:
                feasible.append(info)
            else:
                filtered[info.name] = node_status
        if not feasible:
            return self._post_filter(state, pod, node_infos, filtered)
        best = max(feasible, key=lambda info: (
            self.framework.run_score_plugins(state, pod, info), info.name))
        status = self.framework.run_reserve_plugins(state, pod, best.name)
        if not status.success:
            diagnosis = self._diagnosis(pod, node_infos, {best.name: status})
            return CycleOutcome("fail", diagnosis=diagnosis,
                                message=diagnosis.aggregate_message())
        return CycleOutcome("bind", node=best.name)

    @staticmethod
    def _diagnosis(pod: Pod, node_infos: Dict[str, NodeInfo],
                   filtered: Dict[str, Status]) -> Diagnosis:
        return Diagnosis(pod=pod.namespaced_name, num_nodes=len(node_infos),
                         node_statuses=dict(filtered))

    def _node_infos(self) -> Dict[str, NodeInfo]:
        # read-only views: no filter changes a node or a pod
        infos = {node.name: NodeInfo(node=node)
                 for node in self.store.list("Node", copy=False)}
        for p in self.store.list("Pod", copy=False):
            if p.node in infos and p.phase in (PodPhase.PENDING, PodPhase.RUNNING):
                infos[p.node].add_pod(p)
        return infos

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
