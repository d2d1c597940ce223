"""StateNodeController: a node's events keep ``ClusterState`` in step
with the store, and a virgin MIG node gets its first geometry.

Counterpart of ``nos_tpu/controllers/partitioner/node_controller.py``
(reference internal/controllers/gpupartitioner/node_controller.go:60-135).
A node gone from the store leaves the state; a node of ``kind`` that the
initializer finds uninitialized is initialized first (its write comes
back as another event); the node then enters the state with its bound
pending and running pods, by the store's pod index (``INDEX_POD_NODE``),
in list order. ``add_state_controllers`` wires this controller and
``StatePodController`` on a ``Manager`` with the reference's watches
(``nos_tpu/cmd/partitioner.py:166-177``): nodes carrying the
partitioning label, or deleted, and every pod.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.constants import INDEX_POD_NODE, INDEX_POD_PHASE
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Result, Watch
from nos_tpu_torch.kube.store import DELETED, NodeStore
from nos_tpu_torch.partitioning.core.state import LIVE_PHASES, ClusterState, partitioning_kind

log = logging.getLogger("nos_tpu_torch.partitioner")


def ensure_pod_indexers(store: NodeStore) -> None:
    """The pod indexers the state controllers read (registered once)."""
    if not store.has_indexer("Pod", INDEX_POD_NODE):
        store.add_indexer("Pod", INDEX_POD_NODE, lambda p: [p.node] if p.node else [])
    if not store.has_indexer("Pod", INDEX_POD_PHASE):
        store.add_indexer("Pod", INDEX_POD_PHASE, lambda p: [p.phase])


def bound_live_pods(store: NodeStore, node_name: str) -> list:
    """The node's pending and running pods as stored, by namespace and name."""
    return [p for p in store.list_by_index("Pod", INDEX_POD_NODE, node_name, copy=False)
            if p.phase in LIVE_PHASES]


class StateNodeController:
    def __init__(self, store: NodeStore, cluster_state: ClusterState, initializer=None,
                 kind: str = PARTITIONING_MIG) -> None:
        self.store = store
        self.cluster_state = cluster_state
        self.initializer = initializer
        self.kind = kind
        ensure_pod_indexers(store)

    def reconcile(self, req: Request) -> Optional[Result]:
        node = self.store.try_get("Node", req.name, copy=False)
        if node is None:
            self.cluster_state.delete_node(req.name)
            return None
        if (self.initializer is not None and partitioning_kind(node) == self.kind
                and not self.initializer.is_initialized(node)
                and self.initializer.init_node_partitioning(node)):
            node = self.store.try_get("Node", req.name, copy=False) or node
        self.cluster_state.update_node(node, bound_live_pods(self.store, node.name))
        return None


def add_state_controllers(manager: Manager, cluster_state: ClusterState, initializer=None,
                          kind: str = PARTITIONING_MIG, suffix: str = "",
                          clock: Optional[Callable[[], float]] = None) -> Tuple[str, str]:
    """``state-node<suffix>`` and ``state-pod<suffix>`` on ``manager``'s
    store, feeding ``cluster_state``; their names."""
    from nos_tpu_torch.controllers.partitioner.pod_controller import StatePodController

    store = manager.store
    nodes = StateNodeController(store, cluster_state, initializer, kind)
    pods = StatePodController(store, cluster_state)
    names = (f"state-node{suffix}", f"state-pod{suffix}")
    manager.add(Controller(names[0], store, nodes.reconcile, [Watch(
        "Node", predicate=lambda e: PARTITIONING_LABEL in e.object.labels
        or e.type == DELETED)], clock=clock))
    manager.add(Controller(names[1], store, pods.reconcile, [Watch("Pod")], clock=clock))
    return names
