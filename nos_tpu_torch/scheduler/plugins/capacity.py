"""CapacityScheduling: the elastic quotas at admission, and fair-share
preemption.

Counterpart of ``nos_tpu/scheduler/plugins/capacity.py`` (reference
pkg/scheduler/plugins/capacityscheduling/capacity_scheduling.go:
PreFilter :190-278, PostFilter :323-341 with :468-675, Reserve :343-369;
elasticquotainfo.go:30-361). The quota semantics:

- a namespace may always use up to its guaranteed ``min``;
- it may borrow past ``min`` up to ``max``, but only from the pool of
  guaranteed quota no one uses (the aggregated-min check);
- pods running past ``min`` are labelled over-quota by the quota
  controller, and may be preempted by a namespace still within its
  guaranteed share, which counts its fair part of the unused min:
  guaranteed_overquota_i = floor(min_i / Σmin · Σ_j max(0, min_j - used_j))
  (elasticquotainfo.go:81-152).

The infos built from the store are memoized on the store's revision
(the reference rebuilds them on every PreFilter, a planner's every
trial included): a plan, during which the store does not change, builds
them once. In-flight reservations are folded into a copy.

A request counts ``nos.nebuly.com/gpu-memory`` beside its own resources
(``util/resources.py``); ``gpu_memory_gb`` is the reference's
``NvidiaGpuResourceMemoryGB`` knob. ``set_external_usage``
(``:263-274``) charges each quota usage this store cannot see (a pool
worker's replica holds only its pool's pods,
``partitioning/core/procpool.py``), folded in as one synthetic pod a
quota; a call drops the memoized infos, so the next verdict reads the
new usage at the same store revision.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Set, Tuple

from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import CycleState, NodeInfo, Status
from nos_tpu_torch.util import resources as res

log = logging.getLogger("nos_tpu_torch.scheduler.capacity")

STATE_KEY = "capacity-scheduling"


class ElasticQuotaInfo:
    def __init__(self, name: str, namespaces: Set[str], min_resources: res.ResourceList,
                 max_resources: Optional[res.ResourceList]) -> None:
        self.name = name
        self.namespaces = set(namespaces)
        self.min = dict(min_resources)
        self.max = dict(max_resources) if max_resources else None
        self.used: res.ResourceList = {}
        self.pods: Set[str] = set()

    # ------------------------------------------------------- accounting

    def add_pod(self, key: str, request: res.ResourceList) -> None:
        if key in self.pods:
            return
        self.pods.add(key)
        self.used = res.sum_resources(self.used, request)

    def remove_pod(self, key: str, request: res.ResourceList) -> None:
        if key not in self.pods:
            return
        self.pods.discard(key)
        self.used = res.subtract_resources(self.used, request)

    # ----------------------------------------------------------- checks

    def used_over_min_with(self, request: res.ResourceList) -> bool:
        return any(self.used.get(k, 0) + v > self.min.get(k, 0)
                   for k, v in request.items() if k in self.min)

    def is_borrowing(self) -> bool:
        """Using past its min for some tracked resource
        (capacity_scheduling.go:566-581)."""
        return any(self.used.get(k, 0) > v for k, v in self.min.items())

    def used_over_max_with(self, request: res.ResourceList) -> bool:
        if self.max is None:
            return False
        return any(self.used.get(k, 0) + v > self.max[k]
                   for k, v in request.items() if k in self.max)

    def clone(self) -> "ElasticQuotaInfo":
        c = ElasticQuotaInfo(self.name, self.namespaces, self.min, self.max)
        c.used = dict(self.used)
        c.pods = set(self.pods)
        return c


class ElasticQuotaInfos:
    def __init__(self, infos: List[ElasticQuotaInfo]) -> None:
        self._infos = {i.name: i for i in infos}
        self._by_namespace: Dict[str, ElasticQuotaInfo] = {}
        for info in infos:
            for ns in info.namespaces:
                self._by_namespace[ns] = info

    def __iter__(self):
        return iter(self._infos.values())

    def get(self, name: str) -> Optional[ElasticQuotaInfo]:
        return self._infos.get(name)

    def for_namespace(self, ns: str) -> Optional[ElasticQuotaInfo]:
        return self._by_namespace.get(ns)

    def clone(self) -> "ElasticQuotaInfos":
        return ElasticQuotaInfos([i.clone() for i in self._infos.values()])

    # -------------------------------------------------- aggregate math

    def aggregated_min(self, resource: str) -> float:
        return sum(i.min.get(resource, 0) for i in self._infos.values())

    def aggregated_used(self, resource: str) -> float:
        return sum(i.used.get(resource, 0) for i in self._infos.values())

    def aggregated_used_over_min_with(self, request: res.ResourceList) -> bool:
        """Serving ``request`` would take the cluster's use of a tracked
        resource past the sum of the mins: the borrowing pool is spent
        (capacity_scheduling.go:268-275)."""
        for resource, qty in request.items():
            agg_min = self.aggregated_min(resource)
            if agg_min == 0:
                continue
            if self.aggregated_used(resource) + qty > agg_min:
                return True
        return False

    def guaranteed_overquota(self, name: str, resource: str) -> float:
        """floor(min_i / Σmin · Σ_j max(0, min_j - used_j)): quota ``name``'s
        fair share of the guaranteed quota no one uses."""
        info = self._infos.get(name)
        if info is None:
            return 0
        agg_min = self.aggregated_min(resource)
        if agg_min == 0:
            return 0
        unused = sum(max(0.0, i.min.get(resource, 0) - i.used.get(resource, 0))
                     for i in self._infos.values())
        return math.floor(info.min.get(resource, 0) / agg_min * unused)

    def used_over_entitled(self, name: str) -> bool:
        """used > min + guaranteed_overquota for some tracked resource: the
        quota holds more than its fair share (capacity_scheduling.go:556-563)."""
        info = self._infos.get(name)
        if info is None:
            return False
        return any(info.used.get(k, 0) > info.min.get(k, 0) + self.guaranteed_overquota(name, k)
                   for k in info.min)

    def within_guaranteed_with(self, name: str, request: res.ResourceList) -> bool:
        """used + request ≤ min + guaranteed_overquota for every requested
        resource the quota tracks: the preemptor is entitled to it."""
        info = self._infos.get(name)
        if info is None:
            return False
        for resource, qty in request.items():
            if resource not in info.min:
                continue
            entitled = info.min.get(resource, 0) + self.guaranteed_overquota(name, resource)
            if info.used.get(resource, 0) + qty > entitled:
                return False
        return True


def quota_request(pod: Pod, gpu_memory_gb: Optional[int] = None) -> res.ResourceList:
    """The pod's request with ``nos.nebuly.com/gpu-memory`` added."""
    return res.with_aggregate_gpu_memory(res.compute_pod_request(pod),
                                         gpu_memory_gb or res.DEFAULT_GPU_MEMORY_GB)


def build_quota_infos(store: NodeStore, gpu_memory_gb: Optional[int] = None
                      ) -> ElasticQuotaInfos:
    """The quotas as the plugin sees them (capacityscheduling/informer.go:57-300):
    a composite quota covers its namespaces and shadows their
    ElasticQuotas; usage is rebuilt from the pods bound to nodes."""
    infos: List[ElasticQuotaInfo] = []
    covered: Set[str] = set()
    for ceq in store.list("CompositeElasticQuota", copy=False):
        infos.append(ElasticQuotaInfo(f"ceq/{ceq.name}", set(ceq.namespaces), ceq.min,
                                      ceq.max or None))
        covered.update(ceq.namespaces)
    for eq in store.list("ElasticQuota", copy=False):
        if eq.namespace in covered:
            continue
        infos.append(ElasticQuotaInfo(f"eq/{eq.namespace}/{eq.name}", {eq.namespace}, eq.min,
                                      eq.max or None))
    result = ElasticQuotaInfos(infos)
    for pod in store.list("Pod", copy=False):
        if not pod.node or pod.phase not in (PodPhase.PENDING, PodPhase.RUNNING):
            continue
        info = result.for_namespace(pod.namespace)
        if info is not None:
            info.add_pod(pod.namespaced_name, quota_request(pod, gpu_memory_gb))
    return result


class CapacityScheduling:
    name = "CapacityScheduling"

    def __init__(self, store: NodeStore, gpu_memory_gb: Optional[int] = None) -> None:
        self.store = store
        self.gpu_memory_gb = gpu_memory_gb
        # set by new_framework: preemption re-runs the filters
        self.framework = None
        # reservations in flight (bound this cycle, perhaps not yet
        # listed): quota name → pod key → request
        self._reserved: Dict[str, Dict[str, res.ResourceList]] = {}
        # (store revision, infos built at it); the infos are read-only
        self._built: Optional[Tuple[int, ElasticQuotaInfos]] = None
        # quota name → usage charged outside this store's pods
        self._external: Dict[str, res.ResourceList] = {}
        # the preemptor's record of the last preemption, read by the scheduler
        self.last_preemption: Optional[dict] = None
        # the scheduler's EventRecorder: the preemptor's Preempted events
        self.recorder = None
        # (store revision, node → NodeInfo of its bound live pods): the
        # preemptor's read-only node views, shared by every preemption of
        # one revision
        self.preemption_node_infos: Optional[Tuple[int, Dict[str, NodeInfo]]] = None

    # -------------------------------------------------------- snapshot

    def snapshot(self) -> ElasticQuotaInfos:
        """The store's quotas and usage, with the reservations folded in;
        callers do not mutate it (the preemptor simulates on a clone)."""
        revision = self.store.revision
        if self._built is None or self._built[0] != revision:
            infos = build_quota_infos(self.store, self.gpu_memory_gb)
            for quota_name, usage in self._external.items():
                info = infos.get(quota_name)
                if info is not None:
                    info.add_pod(f"__external__/{quota_name}", usage)
            self._built = (revision, infos)
        infos = self._built[1]
        if not any(self._reserved.values()):
            return infos
        infos = infos.clone()
        for quota_name, pods in self._reserved.items():
            info = infos.get(quota_name)
            if info is None:
                continue
            for key, request in pods.items():
                info.add_pod(key, request)
        return infos

    def set_external_usage(self, usage: Dict[str, res.ResourceList]) -> None:
        """Replace the usage charged outside this store, ``{quota name:
        {resource: quantity}}``, and drop the memoized infos."""
        self._external = {name: dict(request) for name, request in usage.items() if request}
        self._built = None

    def reserved_keys(self) -> Set[str]:
        """The pods holding a reservation."""
        return {key for pods in self._reserved.values() for key in pods}

    # -------------------------------------------------------- prefilter

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        infos = self.snapshot()
        state[STATE_KEY] = infos
        return self.check_quota(pod, infos, self.gpu_memory_gb)

    @staticmethod
    def check_quota(pod: Pod, infos: ElasticQuotaInfos,
                    gpu_memory_gb: Optional[int] = None) -> Status:
        """The quota admission, also run against simulated infos (the
        preemptor re-runs it for each victim set)."""
        info = infos.for_namespace(pod.namespace)
        if info is None:
            return Status.ok()
        request = quota_request(pod, gpu_memory_gb)
        tracked = {k: v for k, v in request.items()
                   if k in info.min or (info.max and k in info.max)}
        if not tracked:
            return Status.ok()
        if info.used_over_max_with(request):
            return Status.unschedulable(f"quota {info.name}: max exceeded",
                                        CapacityScheduling.name)
        if info.used_over_min_with(request) and infos.aggregated_used_over_min_with(
                {k: v for k, v in request.items() if k in info.min}):
            return Status.unschedulable(f"quota {info.name}: cluster guaranteed pool exhausted",
                                        CapacityScheduling.name)
        return Status.ok()

    # --------------------------------------------------------- reserve

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        infos = state.get(STATE_KEY) or self.snapshot()
        info = infos.for_namespace(pod.namespace)
        if info is not None:
            self._reserved.setdefault(info.name, {})[pod.namespaced_name] = quota_request(
                pod, self.gpu_memory_gb)
        return Status.ok()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        self.forget_key(pod.namespaced_name)

    def forget(self, pod: Pod) -> None:
        """Drop the pod's reservation once the store shows it bound."""
        self.forget_key(pod.namespaced_name)

    def forget_key(self, key: str) -> None:
        """Drop a reservation by pod key, for a pod that left the store
        before it was seen bound: a leaked reservation would count
        against its quota for good."""
        for pods in self._reserved.values():
            pods.pop(key, None)

    # ------------------------------------------------------ postfilter

    def post_filter(self, state: CycleState, pod: Pod,
                    filtered_nodes: Dict[str, Status]) -> Optional[str]:
        """Preemption: the node where evicting eligible victims lets the
        pod schedule; they are evicted and the node is returned."""
        from nos_tpu_torch.scheduler.preemption import Preemptor

        infos: ElasticQuotaInfos = state.get(STATE_KEY) or self.snapshot()
        return Preemptor(self.store, self, infos).preempt(state, pod, filtered_nodes)
