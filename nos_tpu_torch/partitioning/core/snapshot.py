"""Cluster snapshot with fork / commit / revert: the planner's working copy.

Counterpart of ``nos_tpu/partitioning/core/snapshot.py`` (reference
internal/partitioning/core/snapshot.go:43-190): ``SnapshotNode`` (``:68``)
and ``ClusterSnapshot`` (``:117``).

Forks are a copy-on-write journal (``:177-245``): ``fork()`` pushes an
empty journal, the first touch of a node under a fork clones only that
node into it (``plan_clone``: the GPUs' used / free), ``revert()``
restores the journaled originals and ``commit()`` folds the journal into
the parent fork (or drops it at the top). Forks nest, and a fork costs
the nodes a trial touches, not the cluster. Mutate only through the
snapshot (``update_geometry_for`` / ``add_pod``): ``get_nodes()`` is
for reading (the reference's journal-on-access ``get_node`` has no user
here).

The cluster's free pool (``:405-458``) is computed once, then kept by the
delta each carve or placement makes on the node it touches, and
checkpointed across fork / revert, so ``get_lacking_slices`` (a pod ×
node trial) walks no nodes.

Mutation versions: each snapshot-level mutation stamps the node it
touches (``SnapshotNode.version``) and the snapshot (``state_version``)
with the next tick of one clock that never repeats. A revert restores
the journaled nodes with their old versions and the checkpointed
``state_version``, so a version-keyed cache (the planner's verdict
cache) finds its entries from before the fork valid again.

``sim_node_infos`` (every node's simulated view, for the filters that
read the whole cluster) and ``has_anti_affinity_pods`` (``:495-518``)
are memoized on ``state_version``, which names one state of the nodes
(a revert restores it with them); a node's view is rebuilt only when its
version moved.

The candidate order is best fit: fewest free slices first, by effective
size (``codec.profile_size``), then by name.

A persistent base (the incremental planner's, ``:249-290``):
``refresh_node`` replaces one node's observed state between plans,
keeping the free pool and the anti-affinity count exact, and stamps the
replacement with a fresh tick, so every version-keyed memo of the old
state becomes unreachable; it refuses to run under a fork (the
replacement would bypass the journal and survive a revert). Adding or
removing a node changes the snapshot's shape: rebuild it instead.
``node_version`` reads one node's tick (-1 when absent).
``DeepcopyClusterSnapshot`` (the reference's bench baseline) is not
ported.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu_torch.kube.store import Node, Pod
from nos_tpu_torch.partitioning.core.codec import SliceCodec, profile_size
from nos_tpu_torch.partitioning.core.partition_state import (
    GpuPartitioning,
    NodePartitioning,
    PartitioningState,
)
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import resources as res


def _anti_affine(pods: List[Pod]) -> int:
    return sum(1 for p in pods if p.pod_anti_affinity)


@dataclass
class SnapshotNode:
    """A partitionable node (``MigNode`` / ``MpsNode``) and its pods."""

    partitionable: object
    # the store's node, shared and never mutated: the base of the
    # scheduler simulation's view
    node: Node
    pods: List[Pod] = field(default_factory=list)
    # True while the node's agent has not acknowledged its spec plan: its
    # geometry is mid-change and must not be carved again
    frozen: bool = False
    # the mutation clock's tick of this node's last snapshot-level change
    version: int = 0

    @property
    def name(self) -> str:
        return self.partitionable.name

    def sim_node_info(self) -> NodeInfo:
        """The node with its allocatable rewritten to the (possibly
        re-carved) geometry: what the scheduler framework filters."""
        sim = copy.copy(self.node)
        sim.allocatable = self.partitionable.sim_allocatable(self.node.allocatable)
        return NodeInfo(node=sim, pods=list(self.pods))

    def add_pod(self, pod: Pod) -> bool:
        if not self.partitionable.add_pod(res.compute_pod_request(pod)):
            return False
        self.pods.append(pod)
        return True

    def plan_clone(self) -> "SnapshotNode":
        """Journal backup: the partitionable's planning state and the pod
        list (pods themselves are never mutated by planning)."""
        return SnapshotNode(partitionable=self.partitionable.plan_clone(), node=self.node,
                            pods=list(self.pods), frozen=self.frozen, version=self.version)


class ClusterSnapshot:
    def __init__(self, nodes: Dict[str, SnapshotNode], codec: SliceCodec) -> None:
        self._nodes = nodes
        self.codec = codec
        # one journal per live fork: node name → backup cloned at first touch
        self._journals: List[Dict[str, SnapshotNode]] = []
        # per fork: (free pool or None, state_version)
        self._pool_backups: List[tuple] = []
        self._free_pool: Optional[res.ResourceList] = None
        self._mutation_clock = itertools.count(1)
        self.state_version = 0
        # node name → (version, free size, has free capacity, has free slices)
        self._free_state_cache: Dict[str, tuple] = {}
        # node name → (version, NodePartitioning) for the projection
        self._part_state_cache: Dict[str, tuple] = {}
        # node name → (version, sim NodeInfo); (state_version, views)
        self._sim_view_cache: Dict[str, tuple] = {}
        self._sim_infos: Optional[tuple] = None
        # (state_version, placed pods with required anti-affinity)
        self._anti: Optional[tuple] = None

    # ------------------------------------------------------ fork/commit

    @property
    def forked(self) -> bool:
        return bool(self._journals)

    def fork(self) -> None:
        """Start a (nestable) copy-on-write trial."""
        self._journals.append({})
        self._pool_backups.append(
            (dict(self._free_pool) if self._free_pool is not None else None,
             self.state_version))
        metrics.SNAPSHOT_FORKS.inc()

    def commit(self) -> int:
        """Keep the current fork's mutations; inside a parent fork the
        journal folds upward, so an outer revert still undoes them.
        Returns the nodes the fork cloned."""
        if not self._journals:
            raise RuntimeError("snapshot not forked")
        journal = self._journals.pop()
        self._pool_backups.pop()
        if self._journals:
            parent = self._journals[-1]
            for name, backup in journal.items():
                parent.setdefault(name, backup)
        metrics.SNAPSHOT_COMMITS.inc()
        return len(journal)

    def revert(self) -> int:
        """Restore the journaled nodes and the pool checkpoint. Returns the
        nodes the fork cloned."""
        if not self._journals:
            raise RuntimeError("snapshot not forked")
        journal = self._journals.pop()
        for name, backup in journal.items():
            self._nodes[name] = backup
        self._free_pool, self.state_version = self._pool_backups.pop()
        metrics.SNAPSHOT_REVERTS.inc()
        return len(journal)

    def _touch(self, name: str) -> None:
        """Journal ``name`` under the innermost fork before its first
        mutation there."""
        if not self._journals:
            return
        journal = self._journals[-1]
        if name in journal:
            return
        node = self._nodes.get(name)
        if node is not None:
            journal[name] = node.plan_clone()

    # --------------------------------------------------------- queries

    def node_count(self) -> int:
        return len(self._nodes)

    def node_version(self, name: str) -> int:
        """One node's mutation tick; -1 when absent."""
        node = self._nodes.get(name)
        return node.version if node is not None else -1

    def refresh_node(self, name: str, replacement: SnapshotNode) -> None:
        """Replace one node's observed state between plans: the free pool
        takes the old → new free-slice delta, the anti-affinity count the
        old and new pod sets, and the replacement a fresh tick."""
        if self._journals:
            raise RuntimeError("refresh_node during an active fork")
        old = self._nodes.get(name)
        if old is None:
            raise KeyError(f"refresh_node: unknown node {name!r}")
        before = dict(old.partitionable.free_slices())
        anti = None
        if self._anti is not None and self._anti[0] == self.state_version:
            anti = (self._anti[1] - _anti_affine(old.pods) + _anti_affine(replacement.pods))
        self._nodes[name] = replacement
        self._apply_free_delta(before, replacement)
        self._stamp(replacement)
        if anti is not None:
            self._anti = (self.state_version, anti)

    def get_nodes(self) -> Dict[str, SnapshotNode]:
        return self._nodes

    def _node_free_state(self, name: str, node: SnapshotNode) -> tuple:
        """(free size, has free capacity, has free slices), memoized on the
        node's version."""
        cached = self._free_state_cache.get(name)
        if cached is not None and cached[0] == node.version:
            return cached[1:]
        part = node.partitionable
        free = part.free_slices()
        size = sum(profile_size(profile) * qty for profile, qty in free.items())
        state = (size, part.has_free_capacity(), bool(free))
        self._free_state_cache[name] = (node.version,) + state
        return state

    def node_has_free_slices(self, name: str) -> bool:
        node = self._nodes.get(name)
        return node is not None and self._node_free_state(name, node)[2]

    def get_candidate_nodes(self) -> List[str]:
        """Nodes whose geometry could still change or serve slices, best
        fit first: fewest free slices (by effective size), then name. The
        reference nos takes name order (snapshot.go:119-130); best fit
        carves small slices out of nodes already fragmented and keeps
        whole GPUs for whole-GPU requests."""
        states = {name: self._node_free_state(name, node)
                  for name, node in self._nodes.items()}
        return [name for name in sorted(self._nodes, key=lambda n: (states[n][0], n))
                if states[name][1] and not self._nodes[name].frozen]

    def sim_node_infos(self) -> List[NodeInfo]:
        """Every node's simulated view (read-only), for the predicates that
        read the whole cluster."""
        if self._sim_infos is None or self._sim_infos[0] != self.state_version:
            views = []
            for name, node in self._nodes.items():
                cached = self._sim_view_cache.get(name)
                if cached is None or cached[0] != node.version:
                    cached = (node.version, node.sim_node_info())
                    self._sim_view_cache[name] = cached
                views.append(cached[1])
            self._sim_infos = (self.state_version, views)
        return self._sim_infos[1]

    def has_anti_affinity_pods(self) -> bool:
        """A placed pod carries required anti-affinity: its terms refuse
        incoming pods, so every trial must see the whole cluster."""
        if self._anti is None or self._anti[0] != self.state_version:
            count = sum(_anti_affine(node.pods) for node in self._nodes.values())
            self._anti = (self.state_version, count)
        return self._anti[1] > 0

    def codec_resources(self, slices: Dict[str, int]) -> res.ResourceList:
        """``{profile: qty}`` as ``{resource: qty}`` in this mode's names."""
        return {self.codec.resource(profile): qty for profile, qty in slices.items()}

    def _compute_free_pool(self) -> res.ResourceList:
        total: res.ResourceList = {}
        for node in self._nodes.values():
            for name, qty in self.codec_resources(node.partitionable.free_slices()).items():
                total[name] = total.get(name, 0) + qty
        return total

    def free_slice_resources(self) -> res.ResourceList:
        """The cluster's free slices (a private copy: ``take_from_pool``
        mutates it)."""
        if self._free_pool is None:
            self._free_pool = self._compute_free_pool()
        return dict(self._free_pool)

    def _stamp(self, node: SnapshotNode) -> None:
        tick = next(self._mutation_clock)
        node.version = tick
        self.state_version = tick

    def _apply_free_delta(self, before: Dict[str, int], node: SnapshotNode) -> None:
        """Fold the change in one node's free slices into the pool."""
        if self._free_pool is None:
            return
        after = node.partitionable.free_slices()
        for profile in set(before) | set(after):
            delta = after.get(profile, 0) - before.get(profile, 0)
            if not delta:
                continue
            name = self.codec.resource(profile)
            updated = self._free_pool.get(name, 0) + delta
            if updated:
                self._free_pool[name] = updated
            else:
                self._free_pool.pop(name, None)

    def take_from_pool(self, pool: res.ResourceList,
                       request: res.ResourceList) -> res.ResourceList:
        """Serve the request's tracked resources from ``pool`` (mutating
        it); what remains lacking."""
        return self.codec.take_from_pool(pool, request)

    def get_lacking_slices(self, pod: Pod) -> res.ResourceList:
        """The pod's tracked resources beyond the cluster's free slices
        (snapshot.go:132-165); every other resource is the scheduler's
        business."""
        return self.take_from_pool(self.free_slice_resources(), res.compute_pod_request(pod))

    # -------------------------------------------------------- mutation

    def update_geometry_for(self, node_name: str, lacking: res.ResourceList) -> bool:
        """Re-carve one node toward ``lacking``, journaled, with the pool
        kept."""
        node = self._nodes.get(node_name)
        if node is None:
            return False
        self._touch(node_name)
        node = self._nodes[node_name]
        before = dict(node.partitionable.free_slices())
        changed = node.partitionable.update_geometry_for(lacking)
        if changed:
            self._apply_free_delta(before, node)
            self._stamp(node)
        return changed

    def add_pod(self, node_name: str, pod: Pod) -> bool:
        node = self._nodes.get(node_name)
        if node is None:
            return False
        self._touch(node_name)
        node = self._nodes[node_name]
        before = dict(node.partitionable.free_slices())
        added = node.add_pod(pod)
        if added:
            self._apply_free_delta(before, node)
            self._stamp(node)
        return added

    # ------------------------------------------------------ projection

    def partitioning_state(self) -> PartitioningState:
        """Every node's current geometry, memoized per (node, version);
        the structures are shared across calls and read-only."""
        out: PartitioningState = {}
        resource = self.codec.resource
        for name, node in self._nodes.items():
            entry = self._part_state_cache.get(name)
            if entry is None or entry[0] != node.version:
                gpus = [GpuPartitioning(index, {resource(p): q for p, q in geometry.items()})
                        for index, geometry in sorted(node.partitionable.geometry().items())]
                entry = (node.version, NodePartitioning(gpus=gpus))
                self._part_state_cache[name] = entry
            out[name] = entry[1]
        return out
