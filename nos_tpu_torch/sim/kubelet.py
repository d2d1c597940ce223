"""SimKubelet: admits bound pods against the devices that exist, then
runs them.

Counterpart of ``nos_tpu/sim/kubelet.py`` (``:38-144``), reconciled per
pod: its watch is the bound pending pods (``SIM_KUBELET_WATCH``, the
reference's ``cmd/cluster.py:213-226``). A real kubelet is the last line
against a bind racing a re-carve: a pod on a MIG node whose MIG demand,
with that of the pods already running there, exceeds the node's
instances (the device pool's geometry, not the node's possibly lagging
allocatable) fails; anything else becomes Running. The flat pod carries
no conditions, so a rejected pod is Failed without the reference's
``OutOfTpu`` condition; ``admission_rejects`` counts them.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from nos_tpu_torch.gpu.node import MIG_RESOURCE_PREFIX, PARTITIONING_LABEL, PARTITIONING_MIG
from nos_tpu_torch.kube.controller import Request, Result, Watch
from nos_tpu_torch.kube.objects import Pod, PodPhase
from nos_tpu_torch.kube.store import DELETED, NodeStore, NotFoundError
from nos_tpu_torch.partitioning.core.codec import is_mig_resource

log = logging.getLogger("nos_tpu_torch.kubelet")

# node → GPU index → profile → count
GeometryFn = Callable[[str], Dict[int, Dict[str, int]]]

SIM_KUBELET_WATCH = Watch("Pod", predicate=lambda e: e.type != DELETED
                          and e.object.phase == PodPhase.PENDING and bool(e.object.node))


def mig_demand(request) -> Dict[str, int]:
    """profile → count of a request's MIG instances."""
    return {name[len(MIG_RESOURCE_PREFIX):]: int(qty) for name, qty in request.items()
            if is_mig_resource(name)}


def add_demand(into: Dict[str, int], demand: Dict[str, int]) -> None:
    for profile, qty in demand.items():
        into[profile] = into.get(profile, 0) + qty


class SimKubelet:
    def __init__(self, store: NodeStore, geometry_fn: Optional[GeometryFn] = None) -> None:
        self.store = store
        self.geometry_fn = geometry_fn
        self.admission_rejects = 0

    def reconcile(self, req: Request) -> Optional[Result]:
        pod = self.store.try_get("Pod", req.name, req.namespace, copy=False)
        if pod is None or not pod.node or pod.phase != PodPhase.PENDING:
            return None
        admitted = self._admit(pod)
        phase = PodPhase.RUNNING if admitted else PodPhase.FAILED
        if not admitted:
            self.admission_rejects += 1
            log.warning("kubelet: rejecting %s on %s: MIG demand exceeds the instances",
                        pod.namespaced_name, pod.node)
        try:
            self.store.patch_merge("Pod", req.name, req.namespace,
                                   lambda p: setattr(p, "phase", phase))
        except NotFoundError:
            pass
        return None

    def _admit(self, pod: Pod) -> bool:
        if self.geometry_fn is None:
            return True
        node = self.store.try_get("Node", pod.node, copy=False)
        if node is None or node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
            return True
        demand = mig_demand(pod.request)
        if not demand:
            return True
        for other in self.store.pods_by_node().get(pod.node, ()):
            if other.phase == PodPhase.RUNNING and other.namespaced_name != pod.namespaced_name:
                add_demand(demand, mig_demand(other.request))
        inventory: Dict[str, int] = {}
        for gpu in self.geometry_fn(pod.node).values():
            add_demand(inventory, gpu)
        return all(inventory.get(p, 0) >= q for p, q in demand.items())
