"""StatePodController: a pod's events keep its binding in
``ClusterState``, adding a node the state does not know yet.

Counterpart of ``nos_tpu/controllers/partitioner/pod_controller.py``
(reference internal/controllers/gpupartitioner/pod_controller.go:47-112).
"""
from __future__ import annotations

from typing import Optional

from nos_tpu_torch.controllers.partitioner.node_controller import (
    bound_live_pods,
    ensure_pod_indexers,
)
from nos_tpu_torch.kube.controller import Request, Result
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.partitioning.core.state import ClusterState


class StatePodController:
    def __init__(self, store: NodeStore, cluster_state: ClusterState) -> None:
        self.store = store
        self.cluster_state = cluster_state
        ensure_pod_indexers(store)

    def reconcile(self, req: Request) -> Optional[Result]:
        pod = self.store.try_get("Pod", req.name, req.namespace, copy=False)
        if pod is None:
            # gone: drop any binding the state holds
            self.cluster_state.delete_pod(Pod(req.name, req.namespace))
            return None
        if pod.node and not self.cluster_state.has_node(pod.node):
            node = self.store.try_get("Node", pod.node, copy=False)
            if node is not None:
                self.cluster_state.update_node(node, bound_live_pods(self.store, pod.node))
                return None
        self.cluster_state.update_pod_usage(pod)
        return None
