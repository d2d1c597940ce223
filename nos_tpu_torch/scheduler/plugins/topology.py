"""Placement quality and the node-pool pin for H100 slices and gangs.

Counterpart of ``nos_tpu/scheduler/plugins/topology.py``:
``TopologyScoring`` stands for ``IciTopologyScoring`` (``:161-217``) and
``MultinodeFilter`` for ``MultihostIciFilter`` (``:220-272``).

The fast-fabric domain is a node pool, ``cloud.google.com/gke-nodepool``,
as in the reference: on H100 it names the pool whose nodes share one
fabric (a GKE A3 pool with compact placement, or one InfiniBand fabric),
where on a TPU it names the ICI domain. NVLink ends at the node.

``TopologyScoring`` adds three signals:

1. exact fit (+50): the node advertises every MIG instance the pod asks
   for, as it is;
2. consolidation (+30 x the used share): the share of the node's MIG
   memory slices in use (a 3g.40gb counts 4), so carved nodes fill
   before whole GPUs are cut;
3. gang pool affinity (+20): a gang member scores higher in a pool where
   a member of its gang is bound.

An MPS request earns neither of the first two, as a shared TPU request
earns neither in the reference. ``MultinodeFilter`` is the hard form of
the third: a member of a multi-node gang (the expander's
``nos.nebuly.com/multihost-topology`` annotation) may only go to the
pool where its gang's bound or Permit-waiting members are; nodes with no
pool label pin nothing.
"""
from __future__ import annotations

from typing import Iterable, Optional, Set

from nos_tpu_torch.kube.store import NodeStore, Pod
from nos_tpu_torch.partitioning.core.codec import effective_size, is_mig_resource
from nos_tpu_torch.scheduler.framework import CycleState, NodeInfo, Status
from nos_tpu_torch.scheduler.plugins.gang import gang_of, is_bound_member
from nos_tpu_torch.util import resources as res

NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
MULTINODE_TOPOLOGY_ANNOTATION = "nos.nebuly.com/multihost-topology"


def _mig_slices(resources) -> float:
    return sum(effective_size(name) * int(qty) for name, qty in resources.items()
               if is_mig_resource(name) and qty > 0)


def member_pools(store: NodeStore, gang_key: str, extra_nodes: Iterable[str] = ()) -> Set[str]:
    """The pools of the nodes the gang's bound members (and
    ``extra_nodes``) lie on; "" for a node with no pool label."""
    ns, name = gang_key.split("/", 1)
    nodes = {p.node for p in store.list("Pod", namespace=ns, copy=False)
             if is_bound_member(p, ns, name)}
    nodes.update(extra_nodes)
    pools = set()
    for node_name in nodes:
        node = store.try_get("Node", node_name, copy=False)
        if node is not None:
            pools.add(node.labels.get(NODEPOOL_LABEL, ""))
    return pools


class TopologyScoring:
    name = "TopologyScoring"

    def __init__(self, store: Optional[NodeStore] = None) -> None:
        self.store = store

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        total = 0
        request = res.compute_pod_request(pod)
        requested = {name: qty for name, qty in request.items() if is_mig_resource(name)}
        if requested:
            available = node_info.available()
            if all(available.get(name, 0) >= qty for name, qty in requested.items()):
                total += 50
            slices = _mig_slices(node_info.node.allocatable)
            if slices > 0:
                total += int(30 * (1 - _mig_slices(available) / slices))
        gang = gang_of(pod)
        if gang is not None and self.store is not None:
            pool = node_info.node.labels.get(NODEPOOL_LABEL)
            if pool and pool in member_pools(self.store, gang[0]):
                total += 20
        return total


class MultinodeFilter:
    name = "Multinode"

    def __init__(self, store: NodeStore, gang=None) -> None:
        self.store = store
        self.gang = gang  # GangScheduling: the members reserved in Permit

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if not pod.annotations.get(MULTINODE_TOPOLOGY_ANNOTATION):
            return Status.ok()
        gang = gang_of(pod)
        if gang is None:
            return Status.ok()
        waiting = ([node for _, node in self.gang.waiting_members(gang[0])]
                   if self.gang is not None else [])
        pools = member_pools(self.store, gang[0], waiting)
        pools.discard("")
        if not pools or node_info.node.labels.get(NODEPOOL_LABEL, "") in pools:
            return Status.ok()
        return Status.unschedulable(
            f"multi-node gang pinned to node pool {sorted(pools)[0]!r}", self.name)
