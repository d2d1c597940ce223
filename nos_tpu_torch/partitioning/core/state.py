"""ClusterState: the partitioner's lock-guarded cache of the cluster.

Counterpart of ``nos_tpu/partitioning/core/state.py`` (reference
internal/partitioning/state/state.go:29-222): a ``NodeInfo`` per node,
pod → node bindings, and a count of nodes per partitioning kind so a
controller can tell cheaply whether its mode is in use. The watch-fed
state controllers (``controllers/partitioner/node_controller.py`` and
``pod_controller.py``) keep it: ``update_node`` / ``delete_node`` on a
node's events, ``update_pod_usage`` / ``delete_pod`` on a pod's.

A node's pods are the pending and running pods bound to it, in the order
a whole sync lists them (the store's: by namespace and name), which the
snapshot takers and the planners iterate in: ``update_pod_usage``
replaces a known pod where it stands and inserts a new one in its place
(where the reference removes and appends); a pod that finished leaves.
Each change gives the ``NodeInfo`` a new list, so its memoized request
sum never goes stale. The state keeps the stored objects as they are (no
one changes one in place: a store replaces an object on every write),
where the reference deep-copies them; ``read_view`` copies only the
containers, ``get_node`` / ``get_nodes`` copy the objects too, for a
caller that will change them.
"""
from __future__ import annotations

import bisect
import copy
import threading
from typing import Dict, List, Optional, Set

from nos_tpu_torch.gpu.node import PARTITIONING_LABEL
from nos_tpu_torch.kube.objects import Node, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import NodeInfo

LIVE_PHASES = (PodPhase.PENDING, PodPhase.RUNNING)


def partitioning_kind(node: Node) -> str:
    """'mig', 'mps' or ''."""
    return node.labels.get(PARTITIONING_LABEL, "")


def _order(pod: Pod) -> tuple:
    return (pod.namespace, pod.name)


class ClusterState:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._bindings: Dict[str, str] = {}  # "ns/name" → node name
        # node name → the pod keys bound there (the reverse of _bindings)
        self._node_pods: Dict[str, Set[str]] = {}
        self._kind_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ bindings

    def _bind(self, key: str, node_name: str) -> None:
        previous = self._bindings.get(key)
        if previous is not None and previous != node_name:
            self._node_pods.get(previous, set()).discard(key)
        self._bindings[key] = node_name
        self._node_pods.setdefault(node_name, set()).add(key)

    def _unbind(self, key: str) -> Optional[str]:
        node_name = self._bindings.pop(key, None)
        if node_name is not None:
            self._node_pods.get(node_name, set()).discard(key)
        return node_name

    @staticmethod
    def _without(info: NodeInfo, pod: Pod) -> None:
        info.pods = [p for p in info.pods
                     if not (p.namespace == pod.namespace and p.name == pod.name)]

    # ------------------------------------------------------------- updates

    def update_node(self, node: Node, pods: List[Pod]) -> None:
        """The node and the pods bound to it (pending or running), kept as
        given: objects no one changes in place."""
        with self._lock:
            old = self._nodes.get(node.name)
            if old is not None:
                self._count_kind(old.node, -1)
            for key in list(self._node_pods.get(node.name, ())):
                self._unbind(key)
            self._nodes[node.name] = NodeInfo(node=node, pods=list(pods))
            for pod in pods:
                self._bind(pod.namespaced_name, node.name)
            self._count_kind(node, +1)

    def delete_node(self, node_name: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_name, None)
            if info is None:
                return
            self._count_kind(info.node, -1)
            for key in self._node_pods.pop(node_name, set()):
                self._bindings.pop(key, None)

    def update_pod_usage(self, pod: Pod) -> None:
        """Track a pod's binding (reference pod_controller.go:47-112): off
        the node it left, onto its node in list order while pending or
        running, off again once finished."""
        with self._lock:
            key = pod.namespaced_name
            node_name = pod.node
            previous = self._bindings.get(key)
            if previous and previous != node_name:
                if previous in self._nodes:
                    self._without(self._nodes[previous], pod)
                self._unbind(key)
            info = self._nodes.get(node_name) if node_name else None
            if info is None:
                return
            if pod.phase not in LIVE_PHASES:
                self._without(info, pod)
                self._unbind(key)
                return
            pods = list(info.pods)
            keys = [_order(p) for p in pods]
            at = bisect.bisect_left(keys, _order(pod))
            if at < len(pods) and keys[at] == _order(pod):
                pods[at] = pod
            else:
                pods.insert(at, pod)
            info.pods = pods
            self._bind(key, node_name)

    def delete_pod(self, pod: Pod) -> None:
        """Forget a pod (its namespace and name are enough)."""
        with self._lock:
            node_name = self._unbind(pod.namespaced_name)
            if node_name and node_name in self._nodes:
                self._without(self._nodes[node_name], pod)

    # ------------------------------------------------------------- queries

    def has_node(self, name: str) -> bool:
        with self._lock:
            return name in self._nodes

    def get_node(self, name: str) -> Optional[NodeInfo]:
        """A copy the caller may change."""
        with self._lock:
            info = self._nodes.get(name)
            if info is None:
                return None
            return NodeInfo(node=copy.deepcopy(info.node),
                            pods=[copy.deepcopy(p) for p in info.pods])

    def get_nodes(self) -> Dict[str, NodeInfo]:
        with self._lock:
            return {name: NodeInfo(node=copy.deepcopy(info.node),
                                   pods=[copy.deepcopy(p) for p in info.pods])
                    for name, info in self._nodes.items()}

    def bindings(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._bindings)

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


def state_from_store(store) -> ClusterState:
    """The state a caught-up pair of state controllers holds, read from
    the store at once: each node carrying the partitioning label, by
    name, with its pending and running bound pods, by namespace and
    name."""
    state = ClusterState()
    by_node = store.pods_by_node()
    for node in store.list("Node", copy=False):
        if PARTITIONING_LABEL in node.labels:
            state.update_node(node, list(by_node.get(node.name, ())))
    return state


class StoreState:
    """The store read as a ``ClusterState`` is: ``read_view`` (a snapshot
    taker's only read) builds ``state_from_store`` when it is called, so
    a plan whose incremental base needs no rebuild reads nothing more."""

    def __init__(self, store) -> None:
        self.store = store

    def read_view(self) -> Dict[str, NodeInfo]:
        return state_from_store(self.store).read_view()
