"""ClusterState: the partitioner's lock-guarded cache of the cluster.

Counterpart of ``nos_tpu/partitioning/core/state.py`` (reference
internal/partitioning/state/state.go:29-222): a ``NodeInfo`` per node,
pod → node bindings, and a count of nodes per partitioning kind so a
controller can tell cheaply whether its mode is in use. ``read_view``
is the snapshot takers' copy-on-read path: it copies only
the containers and shares the Node and Pod objects, which is safe
because no one mutates a stored object in place (an update replaces it
whole; ``update_node`` keeps the store's objects as they are, where the
reference deep-copies them). The port's controllers sync the whole
state from the store each poll (``update_node`` / ``delete_node``) and
snapshot from ``read_view``, so the reference's per-pod bookkeeping
(``update_pod_usage``, ``delete_pod``, the bindings) and its deep-copy
reads (``get_node`` / ``get_nodes``) have no counterpart.
"""
from __future__ import annotations

import threading
from typing import Dict, List

from nos_tpu_torch.gpu.node import PARTITIONING_LABEL
from nos_tpu_torch.kube.store import Node, Pod
from nos_tpu_torch.scheduler.framework import NodeInfo


def partitioning_kind(node: Node) -> str:
    """'mig', 'mps' or ''."""
    return node.labels.get(PARTITIONING_LABEL, "")


class ClusterState:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._kind_counts: Dict[str, int] = {}

    def update_node(self, node: Node, pods: List[Pod]) -> None:
        """The node and the pods bound to it (pending or running), kept as
        given: objects no one changes in place (a store replaces an
        object on every write)."""
        with self._lock:
            old = self._nodes.get(node.name)
            if old is not None:
                self._count_kind(old.node, -1)
            self._nodes[node.name] = NodeInfo(node=node, pods=list(pods))
            self._count_kind(node, +1)

    def delete_node(self, node_name: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_name, None)
            if info is not None:
                self._count_kind(info.node, -1)

    def read_view(self) -> Dict[str, NodeInfo]:
        """A point-in-time read-only view sharing the stored objects."""
        with self._lock:
            return {name: NodeInfo(node=info.node, pods=list(info.pods))
                    for name, info in self._nodes.items()}

    def node_names(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def is_partitioning_enabled(self, kind: str) -> bool:
        with self._lock:
            return self._kind_counts.get(kind, 0) > 0

    def _count_kind(self, node: Node, delta: int) -> None:
        kind = partitioning_kind(node)
        if kind:
            self._kind_counts[kind] = max(0, self._kind_counts.get(kind, 0) + delta)
