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

Fault F6 (ROADMAP.md, shared with the reference, whose filter pins only
from the first member on): the first member took the best-scored node,
and when that node's pool could not hold the rest, the gang timed out
and re-waited in the same pool after every timeout while other pools
stood empty. The port pins the whole gang at once: while no member is
placed, a member may only take a node in a pool whose nodes can hold
every unplaced member now (each member counted on the first node with
room, its request against the node's available resources; members the
expander has not created yet count as the pod itself). The nodes are
the cycle's published view (``TOPOLOGY_NODE_INFOS_KEY``: the
scheduler's, with the Permit claims), else the store's, memoized on its
revision; nodes with no pool label count as one pool. When no pool can
hold the gang now, the first member is not pinned, as before: the carve
has not happened yet (the planner carves for the gang, and the next
cycle after it lands pins the gang to a pool that holds it), or no pool
ever can (the gang waits where its first member lands and times out as
a unit). Once a member is bound or waiting, the pin is its pool's alone,
as in the reference, and a member on a node with no pool label pins
nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core.codec import effective_size, is_mig_resource
from nos_tpu_torch.scheduler.framework import (
    TOPOLOGY_NODE_INFOS_KEY,
    CycleState,
    NodeInfo,
    Status,
)
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, gang_of, is_bound_member
from nos_tpu_torch.util import resources as res

NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
MULTINODE_TOPOLOGY_ANNOTATION = "nos.nebuly.com/multihost-topology"


def _mig_slices(resources) -> float:
    return sum(effective_size(name) * int(qty) for name, qty in resources.items()
               if is_mig_resource(name) and qty > 0)


def member_pools(store: NodeStore, gang_key: str, extra_nodes: Iterable[str] = ()) -> Set[str]:
    """The pools of the nodes the gang's bound members (and
    ``extra_nodes``) lie on; "" for a node with no pool label or no
    longer stored. Empty when no member is bound and ``extra_nodes`` is."""
    ns, name = gang_key.split("/", 1)
    nodes = {p.node for p in store.list("Pod", namespace=ns, copy=False)
             if is_bound_member(p, ns, name)}
    nodes.update(extra_nodes)
    pools = set()
    for node_name in nodes:
        node = store.try_get("Node", node_name, copy=False)
        pools.add(node.labels.get(NODEPOOL_LABEL, "") if node is not None else "")
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
        # (store revision, the store's node views) for unpublished cycles
        self._store_infos: Optional[Tuple[int, List[NodeInfo]]] = None
        self._holding_memo: Dict[tuple, Set[str]] = {}

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if not pod.annotations.get(MULTINODE_TOPOLOGY_ANNOTATION):
            return Status.ok()
        gang = gang_of(pod)
        if gang is None:
            return Status.ok()
        waiting = ([node for _, node in self.gang.waiting_members(gang[0])]
                   if self.gang is not None else [])
        pools = member_pools(self.store, gang[0], waiting)
        pool = node_info.node.labels.get(NODEPOOL_LABEL, "")
        if pools:
            # a member is placed: it pins the gang, unless its node has no pool
            pools.discard("")
            if not pools or pool in pools:
                return Status.ok()
            return Status.unschedulable(
                f"multi-node gang pinned to node pool {sorted(pools)[0]!r}", self.name)
        holding = self.holding_pools(state, pod, gang[0], gang[1])
        if not holding or pool in holding:
            return Status.ok()
        return Status.unschedulable(
            f"multi-node gang fits whole only in node pools {sorted(holding)}", self.name)

    def holding_pools(self, state: CycleState, pod: Pod, gang_key: str, size: int) -> Set[str]:
        """The pools whose nodes can hold every unplaced member of the gang
        now (F6); memoized for the cycle, or on the store's revision."""
        published = state.get(TOPOLOGY_NODE_INFOS_KEY)
        if published is not None:
            memo_key = ("multinode_holding", gang_key)
            if memo_key not in state:
                state[memo_key] = self._holding(published, pod, gang_key, size)
            return state[memo_key]
        revision = self.store.revision
        memo_key = (revision, gang_key, pod.namespaced_name)
        if memo_key not in self._holding_memo:
            if len(self._holding_memo) > 256:
                self._holding_memo.clear()
            self._holding_memo[memo_key] = self._holding(self._infos(revision), pod,
                                                         gang_key, size)
        return self._holding_memo[memo_key]

    def _infos(self, revision: int) -> List[NodeInfo]:
        """The store's node views (bound, live pods), once a revision."""
        if self._store_infos is None or self._store_infos[0] != revision:
            by_node = self.store.pods_by_node()
            self._store_infos = (revision, [
                NodeInfo(node=n, pods=list(by_node.get(n.name, ())))
                for n in self.store.list("Node", copy=False)])
        return self._store_infos[1]

    def _holding(self, infos: List[NodeInfo], pod: Pod, gang_key: str, size: int) -> Set[str]:
        ns, name = gang_key.split("/", 1)
        waiting = ({p.namespaced_name for p, _ in self.gang.waiting_members(gang_key)}
                   if self.gang is not None else set())
        members = [p for p in self.store.list("Pod", namespace=ns, copy=False)
                   if p.labels.get(GANG_NAME_LABEL) == name
                   and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)]
        unplaced = [res.compute_pod_request(p) for p in members
                    if not p.node and p.namespaced_name not in waiting
                    and p.namespaced_name != pod.namespaced_name]
        request = res.compute_pod_request(pod)
        # the pod itself, and the members the expander has not created yet
        created = any(p.namespaced_name == pod.namespaced_name for p in members)
        unplaced += [request] * max(1, size - len(members) + (1 if created else 0))
        free_by_pool: Dict[str, List[dict]] = {}
        for info in infos:
            if info.node.unschedulable:
                continue
            free_by_pool.setdefault(info.node.labels.get(NODEPOOL_LABEL, ""), []).append(
                info.available())
        holding = set()
        for pool, frees in free_by_pool.items():
            frees = [dict(f) for f in frees]
            for want in unplaced:
                room = next((f for f in frees if res.fits(f, want)), None)
                if room is None:
                    break
                for k, v in want.items():
                    room[k] = room.get(k, 0) - v
            else:
                holding.add(pool)
        return holding
