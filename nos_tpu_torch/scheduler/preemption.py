"""The preemptor: victims for a pod the quotas or the nodes refuse.

Counterpart of ``nos_tpu/scheduler/preemption.py`` (reference
capacity_scheduling.go:371-675). Victim selection follows the elastic
quotas (``SelectVictimsOnNode``, :468-675): a victim of the preemptor's
own quota must have a lower priority; a victim of another quota must be
running over-quota (the quota controller's label), and the preemptor
must stay within its guaranteed share (min plus its fair part of the
unused min). Every eligible victim on a node is evicted in simulation,
then victims are reprieved while the pod stays feasible: those whose
eviction would break a PodDisruptionBudget first, then by priority and
newest creation (:626-674). Nodes are compared by PDB violations, then
the top victim priority, the sum of priorities and the count.

Feasible means the quota admission passes on the simulated usage and
the node's filters pass, or, on a MIG node, that the memory slices the
surviving pods leave (8 a GPU, less the slices their MIG instances
hold, counted as the planner counts sizes) hold the pod's MIG request
and every filter but the resource fit passes: the partitioner re-carves
freed slices into any profile. An MPS node has no such headroom.

Victims are units (``VictimUnit``, ``:35-53``): one pod, or a whole
gang (``_eligible_units`` / ``_gang_members``, ``:410-445``). A gang is
eligible only if every member is, its pending members included; it is
reprieved or evicted whole, its whole quota usage frees together in the
simulation, and a PodDisruptionBudget violation counts its pods. Since
a gang's eviction removes pods from other nodes too, the spread and
inter-pod affinity filters of the victim trials read an overlay of the
published cluster view (``:253-360``): trial copies of the remote nodes
the evicted members leave, with the filters' per-cycle caches dropped.
The overlay is taken when the preemptor has spread or affinity terms,
or a victim has anti-affinity (symmetric terms). ``PREEMPTIONS`` counts
the evictions; with the scheduler's ``EventRecorder`` on the quota plugin
(``recorder``) a preemption records ``Preempted`` about the preemptor,
naming its victims (the reference's ``:197-226``).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import CAPACITY_LABEL
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU
from nos_tpu_torch.kube.store import NodeStore, NotFoundError, Pod, PodPhase
from nos_tpu_torch.partitioning.core.codec import effective_size, is_mig_resource
from nos_tpu_torch.scheduler.framework import (
    TOPOLOGY_NODE_INFOS_KEY,
    CycleState,
    InterPodAffinityFit,
    NodeInfo,
    NodeResourcesFit,
    PodTopologySpreadFit,
    Status,
)
from nos_tpu_torch.scheduler.plugins.gang import gang_of
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import pod as podutil
from nos_tpu_torch.util import resources as res

log = logging.getLogger("nos_tpu_torch.scheduler.preemption")


@dataclass
class VictimUnit:
    """The atom of preemption, one pod or one gang: ``local`` are the
    members on the candidate node (they free its capacity), ``members``
    every member in the cluster (all are evicted, all free quota)."""

    local: List[Pod]
    members: List[Pod]

    @property
    def max_priority(self) -> int:
        return max((p.priority for p in self.members), default=0)

    @property
    def newest_creation(self) -> float:
        return max((p.created or 0.0 for p in self.members), default=0.0)


@dataclass
class _NodeVictims:
    units: List[VictimUnit]
    num_pdb_violations: int

    @property
    def pods(self) -> List[Pod]:
        return [p for u in self.units for p in u.members]


class _PdbLedger:
    """The disruptions each PodDisruptionBudget still allows, charged as
    victims are classified (the reference's filterPodsWithPDBViolation)."""

    def __init__(self, store: Optional[NodeStore]) -> None:
        # [namespace, selector, disruptions still allowed] a budget
        self._budgets: List[list] = []
        if store is None:
            return
        pods_by_ns: Dict[str, List[Pod]] = {}
        for pdb in store.list("PodDisruptionBudget", copy=False):
            if pdb.namespace not in pods_by_ns:
                pods_by_ns[pdb.namespace] = store.list("Pod", namespace=pdb.namespace,
                                                       copy=False)
            selector = dict(pdb.selector)
            # terminal pods are outside the budget's expected count
            matching = [p for p in pods_by_ns[pdb.namespace]
                        if selector.items() <= p.labels.items()
                        and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)]
            healthy = sum(1 for p in matching if p.phase == PodPhase.RUNNING)
            if pdb.min_available is not None:
                allowed = healthy - pdb.min_available
            elif pdb.max_unavailable is not None:
                # disruptionsAllowed = currentHealthy - (expected - maxUnavailable)
                allowed = healthy - (len(matching) - pdb.max_unavailable)
            else:
                allowed = healthy
            self._budgets.append([pdb.namespace, selector, max(0, allowed)])

    def clone(self) -> "_PdbLedger":
        c = _PdbLedger(None)
        c._budgets = [list(b) for b in self._budgets]
        return c

    def _matching(self, pod: Pod):
        for budget in self._budgets:
            ns, selector, _ = budget
            if pod.namespace == ns and selector.items() <= pod.labels.items():
                yield budget

    def would_violate(self, unit: VictimUnit) -> bool:
        charges: Dict[int, int] = {}
        for pod in unit.members:
            for budget in self._matching(pod):
                key = id(budget)
                charges[key] = charges.get(key, 0) + 1
                if charges[key] > budget[2]:
                    return True
        return False

    def charge(self, unit: VictimUnit) -> None:
        for pod in unit.members:
            for budget in self._matching(pod):
                budget[2] = max(0, budget[2] - 1)


def mig_slices_in(request: res.ResourceList) -> float:
    """The memory slices a request's MIG instances hold."""
    return sum(effective_size(name) * int(qty) for name, qty in request.items()
               if is_mig_resource(name))


class Preemptor:
    def __init__(self, store: NodeStore, plugin, infos) -> None:
        self.store = store
        self.plugin = plugin  # CapacityScheduling, with its .framework
        self.infos = infos
        # the simulation's requests are counted as the infos' were
        self.gpu_memory_gb = getattr(plugin, "gpu_memory_gb", None)
        # per-cycle memos: the store and the infos are fixed for one cycle
        self._request_cache: Dict[str, res.ResourceList] = {}
        self._entitled_cache: Dict[str, bool] = {}
        self._victim_quota_cache: Dict[str, bool] = {}
        self._gang_cache: Dict[str, List[Pod]] = {}

    def _quota_request(self, pod: Pod) -> res.ResourceList:
        from nos_tpu_torch.scheduler.plugins.capacity import quota_request

        key = pod.namespaced_name
        if key not in self._request_cache:
            self._request_cache[key] = quota_request(pod, self.gpu_memory_gb)
        return self._request_cache[key]

    # ----------------------------------------------------------- entry

    def preempt(self, state: CycleState, pod: Pod,
                filtered_nodes: Dict[str, Status]) -> Optional[str]:
        framework = getattr(self.plugin, "framework", None)
        if framework is None:
            return None
        node_infos = self._node_infos()
        if self.infos.for_namespace(pod.namespace) is None \
                and not self._lower_priority_outside_quotas(pod.priority, node_infos):
            return None  # no pod is eligible anywhere (the first branch of _eligible)
        best: Optional[Tuple[str, _NodeVictims]] = None
        best_key = None
        ledger = _PdbLedger(self.store)
        for node_name in sorted(filtered_nodes):
            node_info = node_infos.get(node_name)
            if node_info is None:
                continue
            victims = self.select_victims_on_node(state, pod, node_info, framework,
                                                  ledger=ledger.clone())
            if victims is None:
                continue
            # pickOneNodeForPreemption's order: fewest PDB violations,
            # lowest top victim priority, smallest priority sum, fewest pods
            key = (victims.num_pdb_violations,
                   max((v.priority for v in victims.pods), default=0),
                   sum(v.priority for v in victims.pods), len(victims.pods))
            if best is None or key < best_key:
                best, best_key = (node_name, victims), key
        if best is None:
            return None
        node_name, victims = best
        self.plugin.last_preemption = self._record(pod, node_name, victims.pods)
        for victim in victims.pods:
            log.info("preempting %s (node %s) for %s", victim.namespaced_name,
                     victim.node or node_name, pod.namespaced_name)
            try:
                self.store.delete("Pod", victim.name, victim.namespace)
                metrics.PREEMPTIONS.labels(namespace=victim.namespace).inc()
            except NotFoundError:
                pass
        recorder = getattr(self.plugin, "recorder", None)
        if recorder is not None:
            from nos_tpu_torch.api.v1alpha1.constants import EVENT_REASON_PREEMPTED

            names = sorted(v.namespaced_name for v in victims.pods)
            recorder.record(pod, EVENT_REASON_PREEMPTED,
                            f"Preempted {len(names)} on {node_name} to fit "
                            f"{pod.namespaced_name}: {', '.join(names)}", type="Warning")
        return node_name

    def _record(self, pod: Pod, node_name: str, victims: List[Pod]) -> dict:
        """What one preemption did, as the invariants read it: the
        preemptor's quota and whether serving it borrows, each victim's
        quota, priority and capacity label when it was evicted."""
        def quota_of(p: Pod) -> Optional[str]:
            info = self.infos.for_namespace(p.namespace)
            return info.name if info is not None else None

        p_info = self.infos.for_namespace(pod.namespace)
        return {"pod": pod.namespaced_name, "priority": pod.priority, "node": node_name,
                "quota": quota_of(pod),
                "borrowing": bool(p_info is not None
                                  and p_info.used_over_min_with(self._quota_request(pod))),
                "victims": [{"pod": v.namespaced_name, "priority": v.priority,
                             "quota": quota_of(v),
                             "capacity": v.labels.get(CAPACITY_LABEL, "")}
                            for v in sorted(victims, key=lambda v: v.namespaced_name)]}

    # ---------------------------------------------------------- victims

    def select_victims_on_node(self, state: CycleState, pod: Pod, node_info: NodeInfo,
                               framework, ledger: Optional[_PdbLedger] = None
                               ) -> Optional[_NodeVictims]:
        units = self._eligible_units(pod, node_info)
        if not units:
            return None
        from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling

        # feasible = the node's filters AND the quota admission on the
        # simulated usage: a victim whose eviction only relieves the quota
        # must not be reprieved
        sim_infos = self.infos.clone()
        needed = mig_slices_in(res.compute_pod_request(pod))

        # a gang's eviction leaves other nodes too: the filters that read
        # the whole cluster see trial copies of those nodes, overlaid on
        # the published view (the candidate's own trial view is the one
        # each filter is handed)
        has_context = (any(c.when_unsatisfiable == "DoNotSchedule"
                           for c in pod.topology_spread_constraints)
                       or bool(pod.pod_affinity or pod.pod_anti_affinity)
                       or any(m.pod_anti_affinity for u in units for m in u.members))
        published = state.get(TOPOLOGY_NODE_INFOS_KEY) if has_context else None
        remote_trials: Dict[str, NodeInfo] = {}

        def remote_trial(node_name: str) -> Optional[NodeInfo]:
            if published is None or node_name == node_info.name:
                return None
            if node_name not in remote_trials:
                for info in published:
                    if info.name == node_name:
                        remote_trials[node_name] = NodeInfo(node=info.node,
                                                            pods=list(info.pods))
                        break
            return remote_trials.get(node_name)

        def filter_state() -> CycleState:
            if published is None or not remote_trials:
                return state
            overlay = CycleState(state)
            overlay[TOPOLOGY_NODE_INFOS_KEY] = [remote_trials.get(i.name, i)
                                                for i in published]
            for key in (PodTopologySpreadFit._CACHE_KEY, InterPodAffinityFit._CACHE_KEY,
                        InterPodAffinityFit._TERM_CACHE_KEY):
                overlay.pop(key, None)
            return overlay

        def feasible(trial: NodeInfo) -> bool:
            if not CapacityScheduling.check_quota(pod, sim_infos, self.gpu_memory_gb).success:
                return False
            fs = filter_state()
            if framework.run_filter_plugins(fs, pod, trial).success:
                return True
            # on a MIG node the current instances are not the limit: the
            # partitioner re-carves freed slices; compare memory slices,
            # and still require every other predicate
            headroom = self._mig_slices_headroom(trial)
            if headroom is None or needed <= 0 or needed > headroom:
                return False
            return all(plugin.filter(fs, pod, trial).success
                       for plugin in framework.filter_plugins
                       if not isinstance(plugin, NodeResourcesFit))

        def evict_sim(unit: VictimUnit) -> None:
            # the whole gang dies, so its whole quota usage frees
            for victim in unit.members:
                v_info = sim_infos.for_namespace(victim.namespace)
                if v_info is not None:
                    v_info.remove_pod(victim.namespaced_name, self._quota_request(victim))
                remote = remote_trial(victim.node) if victim.node else None
                if remote is not None:
                    remote.remove_pod(victim)

        def restore_sim(unit: VictimUnit) -> None:
            for victim in unit.members:
                v_info = sim_infos.for_namespace(victim.namespace)
                if v_info is not None:
                    v_info.add_pod(victim.namespaced_name, self._quota_request(victim))
                remote = remote_trial(victim.node) if victim.node else None
                if remote is not None:
                    remote.add_pod(victim)

        trial = NodeInfo(node=node_info.node, pods=list(node_info.pods))
        for unit in units:
            for p in unit.local:
                trial.remove_pod(p)
            evict_sim(unit)
        if not feasible(trial):
            return None

        # Reprieve (:626-674): PDB-violating units first, then the rest;
        # within each, highest priority, then newest. Classifying charges
        # the shared budgets cumulatively, as filterPodsWithPDBViolation does.
        if ledger is None:
            ledger = _PdbLedger(self.store)
        violating: List[VictimUnit] = []
        non_violating: List[VictimUnit] = []
        for unit in sorted(units, key=lambda u: (-u.max_priority, -u.newest_creation)):
            violates = ledger.would_violate(unit)
            ledger.charge(unit)
            (violating if violates else non_violating).append(unit)

        victims: List[VictimUnit] = []
        num_violations = 0
        for unit, violates in ([(u, True) for u in violating]
                               + [(u, False) for u in non_violating]):
            for p in unit.local:
                trial.add_pod(p)
            restore_sim(unit)
            if feasible(trial):
                continue  # reprieved
            for p in unit.local:
                trial.remove_pod(p)
            evict_sim(unit)
            victims.append(unit)
            if violates:
                num_violations += len(unit.members)
        if not victims:
            return None
        return _NodeVictims(units=victims, num_pdb_violations=num_violations)

    # ------------------------------------------------------------ units

    def _eligible_units(self, preemptor: Pod, node_info: NodeInfo) -> List[VictimUnit]:
        """The node's pods grouped into victim units; a gang's unit is
        eligible only if every member in the cluster is."""
        singles: List[Pod] = []
        gangs: Dict[str, List[Pod]] = {}
        for p in node_info.pods:
            gang = gang_of(p)
            if gang is None:
                singles.append(p)
            else:
                gangs.setdefault(gang[0], []).append(p)
        units = [VictimUnit(local=[p], members=[p]) for p in singles
                 if self._eligible(preemptor, p)]
        for key, local in gangs.items():
            members = self._gang_members(key)
            if members and all(self._eligible(preemptor, m) for m in members):
                units.append(VictimUnit(local=local, members=members))
        return units

    def _gang_members(self, gang_key: str) -> List[Pod]:
        """Every pending or running member of the gang, bound or not: a gang
        dies whole, or its survivors wait on a quorum that cannot re-form.
        Memoized for the preemption."""
        if gang_key not in self._gang_cache:
            ns = gang_key.split("/", 1)[0]
            self._gang_cache[gang_key] = [
                p for p in self.store.list("Pod", namespace=ns, copy=False)
                if p.phase in (PodPhase.PENDING, PodPhase.RUNNING)
                and (gang_of(p) or (None,))[0] == gang_key]
        return self._gang_cache[gang_key]

    def _eligible(self, preemptor: Pod, victim: Pod) -> bool:
        """The reference's SelectVictimsOnNode branches
        (capacity_scheduling.go:512-598), keyed on whether serving the
        preemptor takes its quota past min."""
        if victim.phase not in (PodPhase.PENDING, PodPhase.RUNNING):
            return False
        p_info = self.infos.for_namespace(preemptor.namespace)
        v_info = self.infos.for_namespace(victim.namespace)
        if p_info is None:
            # a preemptor outside every quota: plain priority preemption
            # among pods outside every quota (:585-598)
            return v_info is None and victim.priority < preemptor.priority
        if v_info is None:
            return False
        request = self._quota_request(preemptor)
        if p_info.used_over_min_with(request):
            # the preemptor would borrow: lower-priority pods of its own
            # quota (:536-541); over-quota pods of a quota past its own
            # entitlement, while the preemptor stays within its guaranteed
            # share (:543-564)
            if v_info.name == p_info.name:
                return victim.priority < preemptor.priority
            if not podutil.is_over_quota(victim):
                return False
            if p_info.name not in self._entitled_cache:
                self._entitled_cache[p_info.name] = self.infos.within_guaranteed_with(
                    p_info.name, request)
            if v_info.name not in self._victim_quota_cache:
                self._victim_quota_cache[v_info.name] = self.infos.used_over_entitled(
                    v_info.name)
            return self._entitled_cache[p_info.name] and self._victim_quota_cache[v_info.name]
        # the preemptor is within its min, which others are borrowing:
        # reclaim from any borrowing quota's over-quota pods (:566-581)
        if v_info.name == p_info.name:
            return False
        return podutil.is_over_quota(victim) and v_info.is_borrowing()

    # ----------------------------------------------------------- helpers

    @staticmethod
    def _mig_slices_headroom(trial: NodeInfo) -> Optional[float]:
        """A MIG node's memory slices less those its surviving pods' MIG
        instances hold (None on any other node): what a re-carve could
        shape into any profile."""
        node = trial.node
        if node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
            return None
        spec = KNOWN_GPUS.get(node.labels.get(GPU_PRODUCT_LABEL, ""))
        gpus = int(node.capacity.get(RESOURCE_GPU, 0))
        if spec is None or gpus <= 0:
            return None
        used = sum(mig_slices_in(res.compute_pod_request(p)) for p in trial.pods)
        return gpus * spec.memory_slices - used

    def _lower_priority_outside_quotas(self, priority: int,
                                       node_infos: Dict[str, NodeInfo]) -> bool:
        """A bound live pod outside every quota with a priority below
        ``priority``: the only victims of a preemptor outside every quota."""
        return any(p.priority < priority and self.infos.for_namespace(p.namespace) is None
                   for info in node_infos.values() for p in info.pods)

    def _node_infos(self) -> Dict[str, NodeInfo]:
        """Every node with the pods bound to it, read-only, kept by the
        plugin for the store's revision (the store does not change while
        victims are sought, and every preemption of one revision sees the
        same nodes)."""
        memo = self.plugin.preemption_node_infos
        if memo is not None and memo[0] == self.store.revision:
            return memo[1]
        by_node = self.store.pods_by_node()
        infos = {node.name: NodeInfo(node=node, pods=list(by_node.get(node.name, ())))
                 for node in self.store.list("Node", copy=False)}
        self.plugin.preemption_node_infos = (self.store.revision, infos)
        return infos
