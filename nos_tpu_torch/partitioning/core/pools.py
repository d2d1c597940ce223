"""Pool-sharded planning: partition the cluster, plan each pool, merge.

Counterpart of ``nos_tpu/partitioning/core/pools.py``: ``PoolPartition``
(``:82``), ``SelectorPoolIndex`` (``:107``), the union-find and
``partition_pools`` (``:196-340``), ``split_snapshot`` /
``split_pending`` / ``merge_pool_states``, ``node_capacity`` /
``node_capacities`` and ``check_merge_invariants`` (``:356-520``),
``PoolPlan`` / ``plan_pool`` (one pool's plan, whichever process planned
it) and ``draw_decomposes``. The reference's ``run_pool_plans`` also
plans pools on threads; the planner is pure Python, so threads buy no
parallel work under the GIL, and only ``bench_planner.py`` keeps that
mode, to measure it.

Pools are seeded by the node-pool label ``cloud.google.com/gke-nodepool``
(a node without one seeds ``default``) and merged by a union-find over
the edges that couple planning decisions: a pending pod whose node
selector matches several pools, a gang with members (pending or bound)
across pools, and the pending pods of namespaces whose quota can borrow
(max ≠ min; a composite quota couples all its namespaces). Anything
whose reach is the whole cluster (a pending pod with spread or pod
(anti-)affinity terms or required node affinity, or a placed pod with
required anti-affinity) degrades the partition to one mega pool,
``cluster``. A merged pool takes its smallest seed's name, so pool ids
stay the same while the edges do.

An empty node selector matches every pool, as in the reference
(``:176-188``): a pod with no pool selector merges every pool into one.
``bench_control_plane.py``'s jobs carry no selector, so sharding leaves
that bench at one pool; only traffic pinned to pools by selector (the
``pools`` phase of ``chip_smoke.py``, ``bench_planner --plan-mode
sharded``) shards.

The merge checks run on every sharded plan before it is actuated: no
node claimed by two pools, every node of the partition planned and none
outside it, no node listing one GPU twice, and no node partitioned past
its capacity, so the merge never mints capacity. Capacity is counted in
the planner's effective sizes (``codec.profile_size``): a MIG node holds
its GPUs × the product's memory slices (a 3g.40gb counts 4), an MPS node
its GPUs × the product's GB / 10. Re-carving a GPU to another total is
legal; only the ceiling is checked.

``draw_decomposes`` is the reference's oracle, kept as it is: the
unsharded planner draws every pod from one cluster-wide free pool in its
candidate order, and it asks whether each pod lacks the same drawn from
its own pool's free slices alone. Where it does not hold, a contested
profile may go to different pods (soundly, but not identically). The
reference says the sharded plan then equals the unsharded one exactly;
it need not (ROADMAP.md, fault F7): each pool carves toward its own
pods' lacking totals, the unsharded planner toward the cluster's, so a
GPU can take another geometry though every pod lacks the same. Where
every carve is futile (the steady cluster of ``bench_planner
--plan-mode sharded``) the two are equal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU
from nos_tpu_torch.kube.store import Pod
from nos_tpu_torch.partitioning.core.codec import effective_size
from nos_tpu_torch.partitioning.core.partition_state import NodePartitioning, PartitioningState
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.partitioning.core.verdict_cache import needs_cluster_context
from nos_tpu_torch.scheduler.plugins.gang import gang_of
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from nos_tpu_torch.util import resources as res

# the seed of a node with no node-pool label
DEFAULT_POOL = "default"
# the one pool of a partition that cannot be split
MEGA_POOL = "cluster"


@dataclass
class PoolPartition:
    """One cycle's pools."""

    pools: Tuple[str, ...]  # sorted
    node_pool: Dict[str, str]  # every snapshot node → its pool
    pod_pool: Dict[str, str]  # pending pod → the pool it is planned in
    # merged pool → the seeds folded into it (merges of several seeds only)
    merged_from: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # why the partition degraded to the mega pool ("" when it did not)
    single_pool_reason: str = ""


class SelectorPoolIndex:
    """pool → the (label, value) pairs its nodes carry, with counts, kept
    node by node so routing a selector never walks the cluster.
    ``pools_for`` over-approximates (each pair on some node of the pool,
    not all on one), which only ever merges more."""

    def __init__(self) -> None:
        self._pairs: Dict[str, Dict[tuple, int]] = {}
        # node → (seed, label pairs) as last indexed
        self._node_state: Dict[str, tuple] = {}
        self._pool_nodes: Dict[str, int] = {}

    @staticmethod
    def seed_of(snap_node: SnapshotNode) -> str:
        return snap_node.node.labels.get(NODEPOOL_LABEL, DEFAULT_POOL)

    def rebuild(self, snapshot: ClusterSnapshot) -> None:
        self._pairs, self._node_state, self._pool_nodes = {}, {}, {}
        for name, snap_node in snapshot.get_nodes().items():
            self.note(name, snap_node)

    def note(self, name: str, snap_node: SnapshotNode) -> None:
        """Index (or re-index) one node's labels."""
        self.forget(name)
        pool = self.seed_of(snap_node)
        pairs = tuple(sorted(snap_node.node.labels.items()))
        self._node_state[name] = (pool, pairs)
        self._pool_nodes[pool] = self._pool_nodes.get(pool, 0) + 1
        counts = self._pairs.setdefault(pool, {})
        for pair in pairs:
            counts[pair] = counts.get(pair, 0) + 1

    def forget(self, name: str) -> None:
        state = self._node_state.pop(name, None)
        if state is None:
            return
        pool, pairs = state
        if self._pool_nodes.get(pool, 0) > 1:
            self._pool_nodes[pool] -= 1
        else:
            self._pool_nodes.pop(pool, None)
        counts = self._pairs.get(pool, {})
        for pair in pairs:
            if counts.get(pair, 0) > 1:
                counts[pair] -= 1
            else:
                counts.pop(pair, None)
        if not counts:
            self._pairs.pop(pool, None)

    def seeds(self) -> Tuple[str, ...]:
        return tuple(sorted(self._pool_nodes))

    def pools_for(self, selector_items: Tuple[tuple, ...]) -> Tuple[str, ...]:
        """The pools that may satisfy a node selector, sorted; an empty
        selector matches every pool."""
        if not selector_items:
            return self.seeds()
        return tuple(sorted(pool for pool, counts in self._pairs.items()
                            if all(pair in counts for pair in selector_items)))


class _UnionFind:
    def __init__(self, keys: Iterable[str]) -> None:
        self._parent = {key: key for key in keys}

    def find(self, key: str) -> str:
        root = key
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[key] != root:
            self._parent[key], key = root, self._parent[key]
        return root

    def union(self, a: str, b: str) -> None:
        ra, rb = sorted((self.find(a), self.find(b)))
        if ra != rb:
            self._parent[rb] = ra  # the smaller id stays the root


def _mega(nodes: Iterable[str], pending: List[Pod], reason: str) -> PoolPartition:
    return PoolPartition(pools=(MEGA_POOL,), node_pool={n: MEGA_POOL for n in nodes},
                         pod_pool={p.namespaced_name: MEGA_POOL for p in pending},
                         single_pool_reason=reason)


def _borrowing_namespaces(quotas: Iterable) -> set:
    """Namespaces whose quota may borrow (max ≠ min)."""
    out = set()
    for quota in quotas:
        if tuple(sorted(quota.min.items())) != tuple(sorted(quota.max.items())):
            out.update(getattr(quota, "namespaces", None) or [quota.namespace])
    return out


def partition_pools(snapshot: ClusterSnapshot, pending_pods: List[Pod], quotas: Iterable = (),
                    selector_index: Optional[SelectorPoolIndex] = None) -> PoolPartition:
    """The pools of this cycle: a pure function of the snapshot's nodes,
    the pending pods and the quotas' bounds."""
    nodes = snapshot.get_nodes()
    for pod in pending_pods:
        if needs_cluster_context(pod):
            return _mega(nodes, pending_pods,
                         f"pending pod {pod.namespaced_name} needs cluster-wide context")
        if pod.node_affinity:
            return _mega(nodes, pending_pods,
                         f"pending pod {pod.namespaced_name} has required node affinity")
    if snapshot.has_anti_affinity_pods():
        return _mega(nodes, pending_pods, "placed pods carry required anti-affinity")
    index = selector_index
    if index is None:
        index = SelectorPoolIndex()
        index.rebuild(snapshot)
    seeds = index.seeds()
    if not seeds:
        return _mega(nodes, pending_pods, "no nodes")
    uf = _UnionFind(seeds)
    # a selector several pools satisfy couples them; one none satisfies
    # routes to the first pool, where the pod is reported unserved
    routed: Dict[str, str] = {}
    gang_members: Dict[str, List[str]] = {}
    borrowing = _borrowing_namespaces(quotas)
    coupled: List[str] = []
    for pod in pending_pods:
        matched = index.pools_for(tuple(sorted(pod.node_selector.items())))
        for other in matched[1:]:
            uf.union(matched[0], other)
        routed[pod.namespaced_name] = matched[0] if matched else seeds[0]
        gang = gang_of(pod)
        if gang:
            gang_members.setdefault(gang[0], []).append(pod.namespaced_name)
        if pod.namespace in borrowing:
            coupled.append(pod.namespaced_name)
    # a gang's members, pending or bound, are planned by one pool
    if gang_members:
        bound: Dict[str, List[str]] = {}
        for snap_node in nodes.values():
            for placed in snap_node.pods:
                gang = gang_of(placed)
                if gang and gang[0] in gang_members:
                    bound.setdefault(gang[0], []).append(index.seed_of(snap_node))
        for key, members in gang_members.items():
            anchor = routed[members[0]]
            for member in members[1:]:
                uf.union(anchor, routed[member])
            for pool in bound.get(key, ()):
                uf.union(anchor, pool)
    for name in coupled[1:]:
        uf.union(routed[coupled[0]], routed[name])
    merged: Dict[str, set] = {}
    for seed in seeds:
        merged.setdefault(uf.find(seed), set()).add(seed)
    return PoolPartition(
        pools=tuple(sorted(merged)),
        node_pool={name: uf.find(index.seed_of(n)) for name, n in nodes.items()},
        pod_pool={name: uf.find(pool) for name, pool in routed.items()},
        merged_from={root: tuple(sorted(members)) for root, members in merged.items()
                     if len(members) > 1})


# ------------------------------------------------------------ split / merge

def split_snapshot(snapshot: ClusterSnapshot, partition: PoolPartition
                   ) -> Dict[str, ClusterSnapshot]:
    """One snapshot a pool, of cloned nodes at version 0: each runs its
    own mutation clock, and a tick of the source's must never alias one
    of the pool's."""
    by_pool: Dict[str, Dict[str, SnapshotNode]] = {pool: {} for pool in partition.pools}
    for name, snap_node in snapshot.get_nodes().items():
        clone = snap_node.plan_clone()
        clone.version = 0
        by_pool[partition.node_pool[name]][name] = clone
    return {pool: ClusterSnapshot(nodes, codec=snapshot.codec) for pool, nodes in by_pool.items()}


def split_pending(pending_pods: List[Pod], partition: PoolPartition) -> Dict[str, List[Pod]]:
    """Each pool's pending pods, in their order."""
    out: Dict[str, List[Pod]] = {pool: [] for pool in partition.pools}
    for pod in pending_pods:
        out[partition.pod_pool[pod.namespaced_name]].append(pod)
    return out


def merge_pool_states(states: Dict[str, PartitioningState]) -> PartitioningState:
    """The pools' states as one, by node name: the same whatever order the
    pools finished in."""
    merged: PartitioningState = {}
    for pool in sorted(states):
        merged.update(states[pool])
    return dict(sorted(merged.items()))


def gpu_size(resources: res.ResourceList) -> float:
    """One GPU's partitioned size in effective sizes."""
    return sum(effective_size(name) * qty for name, qty in resources.items())


def node_capacity(snap_node: SnapshotNode) -> Optional[float]:
    """The node's capacity in effective sizes: GPUs × memory slices on a
    MIG node, GPUs × GB / 10 on an MPS node; None for an unknown
    product."""
    node = snap_node.node
    spec = KNOWN_GPUS.get(node.labels.get(GPU_PRODUCT_LABEL, ""))
    gpus = int(node.capacity.get(RESOURCE_GPU, 0))
    if spec is None or not gpus:
        return None
    if node.labels.get(PARTITIONING_LABEL) == PARTITIONING_MIG:
        return float(gpus * spec.memory_slices)
    return gpus * spec.memory_gb / 10


def node_capacities(snapshots: Iterable[ClusterSnapshot]) -> Dict[str, float]:
    """node → capacity over the pool snapshots: the merge check's ceiling."""
    out: Dict[str, float] = {}
    for snapshot in snapshots:
        for name, snap_node in snapshot.get_nodes().items():
            capacity = node_capacity(snap_node)
            if capacity is not None:
                out[name] = capacity
    return out


def check_merge_invariants(partition: PoolPartition,
                           pool_current: Dict[str, PartitioningState],
                           pool_desired: Dict[str, PartitioningState],
                           capacities: Optional[Dict[str, float]] = None) -> List[str]:
    """The violations of the sharded plan, read by people (empty: sound):
    a node claimed twice, a node no pool planned or planned outside its
    pool, a node listing one GPU twice, a node past its capacity."""
    violations: List[str] = []
    seen: Dict[str, str] = {}
    for pool, desired in pool_desired.items():
        for name in desired:
            if name in seen:
                violations.append(f"node {name} claimed by pools {seen[name]} and {pool}")
            seen[name] = pool
            if partition.node_pool.get(name) != pool:
                violations.append(f"node {name} planned by pool {pool} but assigned to "
                                  f"{partition.node_pool.get(name)!r}")
    for name in sorted(set(partition.node_pool) - set(seen)):
        violations.append(f"node {name} missing from every pool plan")
    for pool in sorted(pool_desired):
        current = pool_current.get(pool, {})
        for name in sorted(pool_desired[pool]):
            np: NodePartitioning = pool_desired[pool][name]
            if np is current.get(name):
                continue  # untouched: the memoized projection's own object
            total, indices = 0.0, set()
            for gpu in np.gpus:
                total += gpu_size(gpu.resources)
                if gpu.gpu_index in indices:
                    violations.append(f"pool {pool}: node {name} lists GPU {gpu.gpu_index} twice")
                indices.add(gpu.gpu_index)
            cap = (capacities or {}).get(name)
            if cap is not None and total > cap + 1e-9:
                violations.append(f"pool {pool}: node {name} desired {total} slices exceeds "
                                  f"capacity {cap}")
    return violations


# ---------------------------------------------------------------- execution

@dataclass
class PoolPlan:
    """One pool's plan, whichever process planned it: the pool's state
    before and after, its ledger, its planner's seconds, and the backend
    (``serial``, ``process``, or ``escalated``: a worker's pool planned in
    the parent)."""

    current: PartitioningState
    desired: PartitioningState
    unserved: Dict[str, str]
    pending_ages: Dict[str, float]
    plan_mode: str
    seconds: float
    backend: str


def plan_pool(planner, snapshot: ClusterSnapshot, pending: List[Pod], dirty: Optional[set],
              pending_ages: Optional[Dict[str, float]] = None,
              backend: str = "serial") -> PoolPlan:
    """Plan one pool in this process."""
    current = snapshot.partitioning_state()
    t0 = time.perf_counter()
    desired = planner.plan(snapshot, pending, pending_ages=pending_ages, dirty=dirty)
    return PoolPlan(current, desired, dict(planner.last_unserved),
                    dict(planner.last_pending_ages), planner.last_plan_mode,
                    time.perf_counter() - t0, backend)


def draw_decomposes(snapshot: ClusterSnapshot, partition: PoolPartition,
                    candidates: List[Pod]) -> bool:
    """Whether each candidate (in the planner's draw order) lacks the same
    drawn from its own pool's free slices as from the cluster's (not
    enough for equal plans: F7)."""
    codec = snapshot.codec
    cluster_free = snapshot.free_slice_resources()
    pool_free: Dict[str, res.ResourceList] = {pool: {} for pool in partition.pools}
    for name, snap_node in snapshot.get_nodes().items():
        free = pool_free[partition.node_pool[name]]
        for profile, qty in snap_node.partitionable.free_slices().items():
            resource = codec.resource(profile)
            free[resource] = free.get(resource, 0) + qty
    for pod in candidates:
        request = res.compute_pod_request(pod)
        if codec.take_from_pool(cluster_free, request) != codec.take_from_pool(
                pool_free[partition.pod_pool[pod.namespaced_name]], request):
            return False
    return True
