"""Quota accounting and the over-quota labels.

Counterpart of ``nos_tpu/controllers/elasticquota/controller.py``
(reference internal/controllers/elasticquota/elasticquota_controller.go:66-189,
elasticquota.go:38-149 and compositeelasticquota_controller.go:110-137):
a quota's running pods are walked in a fixed order (``sort_pods_for_quota``),
each one's request, with ``nos.nebuly.com/gpu-memory`` added and cut to
the resources ``min`` names, is summed into ``used``, a pod whose sum
still fits ``min`` is labelled in-quota and the rest over-quota (the
preemptor picks its cross-quota victims by that label), and ``used`` is
written to the quota. A CompositeElasticQuota does the same over its
namespace list, and deletes the ElasticQuotas of those namespaces first.

The operator component (``cmd/operator.py``) runs each reconciler on
its quota's watch and the pod watch (``pod_to_quota_requests``, the
reference's mapper), through ``reconcile_request``. ``SimCluster``
polls: ``ElasticQuotaController.step()`` reconciles every composite
quota, then every ElasticQuota, each time it is called. The reconcile
keeps its ``elasticquota.reconcile`` span. With an ``EventRecorder``
(``recorder``) a pod labelled over-quota records ``QuotaBorrowed`` and
one flipped from over-quota back to in-quota ``QuotaReclaimed`` (a
pod's first in-quota label is no news; the reference's ``:115-160``);
with a ``FlightRecorder`` each reconcile writes a ``quota.reconcile``
record: the store revision read before its writes, the usage and the
label flips ([pod key, new label]) in the order they were written.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import (
    CAPACITY_IN_QUOTA,
    CAPACITY_LABEL,
    CAPACITY_OVER_QUOTA,
)
from nos_tpu_torch.kube.controller import Request, Result
from nos_tpu_torch.kube.store import NodeStore, NotFoundError, Pod, PodPhase, WatchEvent
from nos_tpu_torch.util import resources as res
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.elasticquota")


def sort_pods_for_quota(pods: List[Pod], gpu_memory_gb: int = res.DEFAULT_GPU_MEMORY_GB
                        ) -> List[Pod]:
    """The accounting order (elasticquota.go:77-104): older pods first
    (they claimed quota first), then higher priority, then the smaller
    request summed over its resources with the memory aggregate, then
    namespace and name. A pod no store created has no creation time and
    sorts as created at 0."""
    return sorted(pods, key=lambda p: (
        p.created or 0.0, -p.priority,
        sum(res.with_aggregate_gpu_memory(res.compute_pod_request(p), gpu_memory_gb).values()),
        p.namespace, p.name))


def _filter_to_min(request: res.ResourceList, min_resources: res.ResourceList
                   ) -> res.ResourceList:
    """A quota tracks only the resources its min names (elasticquota.go:64-69)."""
    return {k: v for k, v in request.items() if k in min_resources}


def quota_accounting(pods: List[Pod], quota_min: res.ResourceList,
                     gpu_memory_gb: int = res.DEFAULT_GPU_MEMORY_GB
                     ) -> Tuple[res.ResourceList, Dict[str, str]]:
    """(used, namespaced name → capacity label) for a quota's running
    pods: each pod's request, with the memory aggregate and cut to the
    resources ``min`` names, summed in the accounting order; a pod whose
    running sum still fits ``min`` is in-quota."""
    used: res.ResourceList = {}
    labels: Dict[str, str] = {}
    for pod in sort_pods_for_quota(pods, gpu_memory_gb):
        request = _filter_to_min(
            res.with_aggregate_gpu_memory(res.compute_pod_request(pod), gpu_memory_gb),
            quota_min)
        used = res.sum_resources(used, request)
        labels[pod.namespaced_name] = (CAPACITY_IN_QUOTA if res.fits(quota_min, used)
                                       else CAPACITY_OVER_QUOTA)
    return used, labels


def pod_to_quota_requests(store: NodeStore, event: WatchEvent) -> List[Request]:
    """The pod watch's mapper: a pod's event maps to the quotas covering
    its namespace (reference elasticquota_controller.go:140-164)."""
    ns = event.object.namespace
    out = [Request(q.name, ns) for q in store.list("ElasticQuota", namespace=ns, copy=False)]
    out += [Request(q.name, q.namespace)
            for q in store.list("CompositeElasticQuota", copy=False) if ns in q.namespaces]
    return out


class _QuotaReconcilerBase:
    def __init__(self, store: NodeStore, gpu_memory_gb: Optional[int] = None, recorder=None,
                 flight_recorder=None) -> None:
        self.store = store
        # the NvidiaGpuResourceMemoryGB knob: the GB a plain nvidia.com/gpu counts
        self.gpu_memory_gb = gpu_memory_gb or res.DEFAULT_GPU_MEMORY_GB
        self.recorder = recorder  # an EventRecorder: the capacity-label flips
        self.flight_recorder = flight_recorder  # a FlightRecorder: quota.reconcile

    def _running_pods(self, namespaces: List[str]) -> List[Pod]:
        # read-only: the labels are written through patch_labels
        return [p for ns in namespaces for p in self.store.list("Pod", namespace=ns, copy=False)
                if p.phase == PodPhase.RUNNING]

    def _reconcile_quota(self, quota, namespaces: List[str]) -> int:
        """Label the quota's running pods and write its used; the writes
        made."""
        with TRACER.span("elasticquota.reconcile", quota=f"{quota.namespace}/{quota.name}"):
            # the watermark before this reconcile's own writes
            revision = self.store.revision
            writes = 0
            flips: List[List[str]] = []
            pods = self._running_pods(namespaces)
            used, labels = quota_accounting(pods, quota.min, self.gpu_memory_gb)
            for pod in pods:
                desired = labels[pod.namespaced_name]
                previous = pod.labels.get(CAPACITY_LABEL)
                if previous != desired:
                    try:
                        self.store.patch_labels("Pod", pod.name, pod.namespace,
                                                {CAPACITY_LABEL: desired})
                        writes += 1
                    except NotFoundError:
                        continue
                    self._record_flip(quota, pod, desired, previous)
                    flips.append([pod.namespaced_name, desired])
            if quota.used != used:
                self.store.patch_merge(quota.kind, quota.name, quota.namespace,
                                       lambda q: setattr(q, "used", used))
                writes += 1
            if self.flight_recorder is not None:
                self.flight_recorder.record_quota_reconcile(
                    quota=f"{quota.namespace}/{quota.name}".lstrip("/"), revision=revision,
                    used=dict(used), flips=flips)
            return writes

    def _record_flip(self, quota, pod: Pod, label: str, previous: Optional[str]) -> None:
        if self.recorder is None:
            return
        from nos_tpu_torch.api.v1alpha1.constants import (
            EVENT_REASON_QUOTA_BORROWED,
            EVENT_REASON_QUOTA_RECLAIMED,
        )

        name = f"{quota.namespace}/{quota.name}".lstrip("/")
        if label == CAPACITY_IN_QUOTA:
            if previous != CAPACITY_OVER_QUOTA:
                return  # the first in-quota label is the steady state
            self.recorder.record(pod, EVENT_REASON_QUOTA_RECLAIMED,
                                 f"{pod.namespaced_name} back within {quota.kind} {name} "
                                 "guaranteed quota")
        else:
            self.recorder.record(pod, EVENT_REASON_QUOTA_BORROWED,
                                 f"{pod.namespaced_name} running on capacity borrowed over "
                                 f"{quota.kind} {name} min (preemptible)", type="Warning")

    def reconcile_request(self, req: Request) -> Optional[Result]:
        """``reconcile`` on a watch's request."""
        self.reconcile(req.name, req.namespace)
        return None


class ElasticQuotaReconciler(_QuotaReconcilerBase):
    def reconcile(self, name: str, namespace: str) -> int:
        quota = self.store.try_get("ElasticQuota", name, namespace)
        if quota is None:
            return 0
        return self._reconcile_quota(quota, [quota.namespace])


class CompositeElasticQuotaReconciler(_QuotaReconcilerBase):
    def reconcile(self, name: str, namespace: str) -> int:
        quota = self.store.try_get("CompositeElasticQuota", name, namespace)
        if quota is None:
            return 0
        writes = 0
        # a composite quota shadows the ElasticQuotas of its namespaces
        # (compositeelasticquota_controller.go:110-137)
        for eq in self.store.list("ElasticQuota"):
            if eq.namespace in quota.namespaces:
                log.info("deleting ElasticQuota %s/%s overlapped by CompositeElasticQuota %s",
                         eq.namespace, eq.name, quota.name)
                try:
                    self.store.delete("ElasticQuota", eq.name, eq.namespace)
                    writes += 1
                except NotFoundError:
                    pass
        return writes + self._reconcile_quota(quota, list(quota.namespaces))


class ElasticQuotaController:
    """Both reconcilers over every quota in the store, polled."""

    def __init__(self, store: NodeStore, gpu_memory_gb: Optional[int] = None) -> None:
        self.store = store
        self.elastic = ElasticQuotaReconciler(store, gpu_memory_gb)
        self.composite = CompositeElasticQuotaReconciler(store, gpu_memory_gb)

    def step(self) -> int:
        """Every composite quota, then every ElasticQuota left; the store
        writes made."""
        writes = sum(self.composite.reconcile(q.name, q.namespace)
                     for q in self.store.list("CompositeElasticQuota"))
        return writes + sum(self.elastic.reconcile(q.name, q.namespace)
                            for q in self.store.list("ElasticQuota"))
