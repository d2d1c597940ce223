"""The scheduler: one scheduling cycle per pending pod, polled.

Counterpart of ``nos_tpu/scheduler/scheduler.py``: ``new_framework``
(``:50``), ``Scheduler.schedule_one`` / ``_decide`` (``:207-402``),
``_bind`` (``:541``) and ``_mark_unschedulable`` (``:574``). A cycle runs
PreFilter → Filter over every node → Score → Reserve → Bind; when no node
passes, the pod's PodScheduled=False / Unschedulable condition is set
with the diagnosis as its message, the signal the partitioner batches
on. The port has no controller manager and no watches: ``step()`` runs a
cycle for every pending pod this scheduler owns (highest priority first,
then by namespace and name), and ``start()`` runs the steps on a thread
of its own every ``interval`` seconds until ``stop()``, as ``MigAgent``
does. PostFilter preemption, Permit and gangs, and ``CapacityScheduling``
wait for the quota and gang slices (ROADMAP.md).
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

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
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.scheduler")


def new_framework() -> Framework:
    """The default plugin wiring: the vanilla predicates and the taint
    score."""
    return Framework(filter_plugins=vanilla_filter_plugins(),
                     score_plugins=[TaintTolerationScoring()])


@dataclass
class CycleOutcome:
    """One cycle's decision, before its store write."""

    decision: str  # bind | fail
    node: str = ""
    diagnosis: Optional[Diagnosis] = None
    message: str = ""


class Scheduler:
    def __init__(self, store: NodeStore, framework: Optional[Framework] = None,
                 scheduler_name: str = "", interval: float = 0.5) -> None:
        self.store = store
        self.framework = framework or new_framework()
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
        pending = [p for p in self.store.list("Pod")
                   if p.phase == PodPhase.PENDING and not p.node and self.responsible_for(p)]
        pending.sort(key=lambda p: (-p.priority, p.namespace, p.name))
        bound = 0
        for pod in pending:
            bound += self.schedule_one(pod).decision == "bind"
        return bound

    def schedule_one(self, pod: Pod) -> CycleOutcome:
        with TRACER.span("scheduler.cycle", pod=pod.namespaced_name) as span:
            outcome = self._decide(pod)
            span.set_attributes(decision=outcome.decision, node=outcome.node)
            if outcome.decision == "bind":
                self._bind(pod, outcome.node)
            else:
                self._mark_unschedulable(pod, outcome.message)
        return outcome

    def _decide(self, pod: Pod) -> CycleOutcome:
        state = CycleState()
        node_infos = self._node_infos()
        status = self.framework.run_pre_filter_plugins(state, pod)
        if not status.success:
            diagnosis = self._diagnosis(pod, node_infos, {name: status for name in node_infos})
            return CycleOutcome("fail", diagnosis=diagnosis,
                                message=diagnosis.aggregate_message())
        feasible: List[NodeInfo] = []
        filtered: Dict[str, Status] = {}
        for info in node_infos.values():
            node_status = self.framework.run_filter_plugins(state, pod, info)
            if node_status.success:
                feasible.append(info)
            else:
                filtered[info.name] = node_status
        if not feasible:
            diagnosis = self._diagnosis(pod, node_infos, filtered)
            return CycleOutcome("fail", diagnosis=diagnosis,
                                message=diagnosis.aggregate_message())
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
        infos = {node.name: NodeInfo(node=node) for node in self.store.list("Node")}
        for p in self.store.list("Pod"):
            if p.node in infos and p.phase in (PodPhase.PENDING, PodPhase.RUNNING):
                infos[p.node].add_pod(p)
        return infos

    # ----------------------------------------------------------- writes

    def _bind(self, pod: Pod, node_name: str) -> None:
        def mutate(p: Pod) -> None:
            p.node = node_name
            p.unschedulable = False
            p.unschedulable_message = ""

        try:
            self.store.patch_merge("Pod", pod.name, pod.namespace, mutate)
        except NotFoundError:
            return
        log.info("scheduler: bound %s to %s", pod.namespaced_name, node_name)

    def _mark_unschedulable(self, pod: Pod, message: str) -> None:
        if pod.unschedulable:
            return  # already marked; no patch churn

        def mutate(p: Pod) -> None:
            p.unschedulable = True
            p.unschedulable_message = message

        try:
            self.store.patch_merge("Pod", pod.name, pod.namespace, mutate)
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
