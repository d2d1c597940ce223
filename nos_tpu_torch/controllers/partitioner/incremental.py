"""Persistent-snapshot maintenance for incremental replanning.

Counterpart of ``nos_tpu/controllers/partitioner/incremental.py``:
``IncrementalSnapshotMaintainer`` (``:72-256``) and
``_quota_spec_signature`` (``:257``). The maintainer keeps one base
``ClusterSnapshot`` of its mode alive across plans and turns the store's
writes since the last plan into a *dirty set* of node names:

- a Node write dirties that node;
- a Pod write dirties the node the pod was bound to before or after it
  (an unbound pending pod touches no node's observed state);
- an ElasticQuota or CompositeElasticQuota whose spec moved (bounds,
  namespaces, create, delete) forces a rebuild (quota bounds are
  cluster-wide planner inputs); a write that moved only its status (the
  quota controller's ``used`` after every bind) is ignored: the snapshot
  holds no quota state and ``CapacityScheduling`` reads the live store
  on every trial. Without that, each plan's own binds would force a
  rebuild next plan;
- a node entering or leaving the mode's scope (deleted, relabelled) or
  whose GPU product changed forces a rebuild: the snapshot has no way to
  add or remove a node, by design;
- a reader that fell behind the store's journal (``JOURNAL_LENGTH``
  writes) rebuilds, as the reference does on a drain overflow.

The reference drains watch events; the port reads the store's change
journal (``NodeStore.changes_since``) from the revision it last saw.
Dirty nodes are re-snapshotted from the live store through the taker's
``take_snapshot_node``, the constructor the whole take uses, and swapped
into the base with ``ClusterSnapshot.refresh_node``, which keeps the
free pool and the anti-affinity count exact and stamps a fresh tick. A
refresh of an unchanged node is harmless. ``snapshot()`` returns
``(base, dirty)``; a rebuild reports every node dirty, and the planner
maps a new snapshot object or too large a dirty set to its fallback on
its own.

``PoolShardedMaintainer`` (``:267-363``) layers one persistent snapshot
a pool (``partitioning/core/pools.py``) over the inner maintainer's
base: each cycle the partition is recomputed from the base, the pending
pods and the quotas' bounds through a selector index kept node by node.
While every node keeps its pool, a dirty node's fresh state is cloned
into its own pool's snapshot (``refresh_node``) and no other pool
notices; a no-op cycle keeps every pool snapshot as it is. Any change of
``node_pool`` (a gang now spanning two pools, a relabelled node, an
unpinned pod merging everything), a new base, or ``force_rebuild`` (the
escape hatch after a failed merge check or a lost pool worker) rebuilds
every pool snapshot from the base and reports each pool wholly dirty.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL
from nos_tpu_torch.kube.store import Change, NodeStore, Pod
from nos_tpu_torch.partitioning.core.pools import (
    PoolPartition,
    SelectorPoolIndex,
    partition_pools,
    split_snapshot,
)
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot

log = logging.getLogger("nos_tpu_torch.partitioner")

QUOTA_KINDS = ("ElasticQuota", "CompositeElasticQuota")


def _quota_spec_signature(quota) -> tuple:
    """The planner-relevant part of a quota: its bounds (and a composite's
    namespaces); its status is derived state the planner reads live."""
    return (tuple(sorted(quota.min.items())), tuple(sorted(quota.max.items())),
            tuple(getattr(quota, "namespaces", ())))


class IncrementalSnapshotMaintainer:
    """The persistent base snapshot of one partitioner mode and its dirty
    sets. Single-threaded: only its controller's step calls
    ``snapshot``."""

    def __init__(self, store: NodeStore, snapshot_taker, kind: str) -> None:
        self.store = store
        self.taker = snapshot_taker
        self.kind = kind
        self._base: Optional[ClusterSnapshot] = None
        self._revision = 0  # the store revision the base has seen
        self._names: Set[str] = set()
        self._quota_specs: Dict[Tuple[str, str, str], tuple] = {}
        self.full_rebuilds = 0
        self.nodes_refreshed = 0

    def snapshot(self, cluster_state) -> Tuple[ClusterSnapshot, Set[str]]:
        """The base and the nodes refreshed since the last call (every
        node after a rebuild)."""
        if self._base is None:
            return self._rebuild(cluster_state)
        revision = self.store.revision
        changes = self.store.changes_since(self._revision)
        if changes is None:
            log.info("partitioner[%s]: the store's journal overflowed; rebuilding the snapshot",
                     self.kind)
            return self._rebuild(cluster_state)
        self._revision = revision
        dirty, rebuild = self._classify(changes)
        if not rebuild:
            refreshed = self._refresh(dirty)
            if refreshed is not None:
                return self._base, refreshed
        return self._rebuild(cluster_state)

    def _classify(self, changes: List[Change]) -> Tuple[Set[str], bool]:
        """(dirty node names, rebuild?): any change whose node-local reach
        is unclear rebuilds."""
        dirty: Set[str] = set()
        for change in changes:
            if change.kind in QUOTA_KINDS:
                key = (change.kind, change.namespace, change.name)
                if change.type == "DELETED":
                    if key in self._quota_specs:
                        return dirty, True
                    continue
                if change.type == "MODIFIED" and not change.spec_changed \
                        and key in self._quota_specs:
                    continue  # status only: planner-neutral
                return dirty, True
            if change.kind == "Pod":
                for node in (change.node_before, change.node_after):
                    if node and node in self._names:
                        dirty.add(node)
            elif change.kind == "Node":
                if change.type == "DELETED":
                    if change.name in self._names:
                        return dirty, True
                    continue
                dirty.add(change.name)  # scope resolved against the store
        return dirty, False

    def _refresh(self, dirty: Set[str]) -> Optional[Set[str]]:
        """Re-snapshot each dirty node from the live store into the base;
        the names refreshed, or None when a node entered or left the
        scope or changed product (the caller rebuilds)."""
        if not dirty:
            return set()
        nodes = {n.name: n for n in self.store.list("Node", copy=False) if n.name in dirty}
        by_node = self.store.pods_by_node()
        refreshed: Set[str] = set()
        for name in sorted(dirty):
            node = nodes.get(name)
            in_base = name in self._names
            entry = (self.taker.take_snapshot_node(node, list(by_node.get(name, ())))
                     if node is not None else None)
            if entry is None:
                if in_base:
                    return None  # left the scope
                continue  # another mode's node
            if not in_base:
                return None  # entered the scope
            old = self._base.get_nodes()[name]
            if old.node.labels.get(GPU_PRODUCT_LABEL) != node.labels.get(GPU_PRODUCT_LABEL):
                return None
            self._base.refresh_node(name, entry)
            refreshed.add(name)
        self.nodes_refreshed += len(refreshed)
        return refreshed

    def _rebuild(self, cluster_state) -> Tuple[ClusterSnapshot, Set[str]]:
        self._revision = self.store.revision
        self._base = self.taker.take_snapshot(cluster_state)
        self._names = set(self._base.get_nodes())
        self._quota_specs = {(kind, q.namespace, q.name): _quota_spec_signature(q)
                             for kind in QUOTA_KINDS
                             for q in self.store.list(kind, copy=False)}
        self.full_rebuilds += 1
        return self._base, set(self._names)



class PoolShardedMaintainer:
    """The persistent snapshot of each pool of one partitioner mode, over
    an ``IncrementalSnapshotMaintainer``. Single-threaded, as the inner
    one; the pool snapshots share no node, so they may be planned at
    once."""

    def __init__(self, store: NodeStore, snapshot_taker, kind: str) -> None:
        self.inner = IncrementalSnapshotMaintainer(store, snapshot_taker, kind)
        self.store = store
        self.kind = kind
        self._index = SelectorPoolIndex()
        self._base: Optional[ClusterSnapshot] = None
        self._partition: Optional[PoolPartition] = None
        self._pool_bases: Dict[str, ClusterSnapshot] = {}
        # whether the last shard() rebuilt the pool snapshots: the
        # controller makes new pool planners exactly then
        self.last_rebuilt = False
        self._force_rebuild = False
        self.pool_rebuilds = 0

    def force_rebuild(self) -> None:
        """Rebuild the pool snapshots at the next ``shard()``."""
        self._force_rebuild = True

    def shard(self, cluster_state, pending_pods: List[Pod]):
        """(base, base dirty, partition, pool snapshots, pool dirty sets)."""
        snapshot, dirty = self.inner.snapshot(cluster_state)
        nodes = snapshot.get_nodes()
        if snapshot is not self._base:
            self._base = snapshot
            self._index.rebuild(snapshot)
        else:
            for name in dirty:
                if name in nodes:
                    self._index.note(name, nodes[name])
        quotas = [q for kind in QUOTA_KINDS for q in self.store.list(kind, copy=False)]
        partition = partition_pools(snapshot, pending_pods, quotas=quotas,
                                    selector_index=self._index)
        rebuild = (self._force_rebuild or self._partition is None
                   or partition.node_pool != self._partition.node_pool)
        self._force_rebuild = False
        if rebuild:
            self._pool_bases = split_snapshot(snapshot, partition)
            pool_dirty = {pool: set(base.get_nodes()) for pool, base in self._pool_bases.items()}
            self.pool_rebuilds += 1
        else:
            pool_dirty = {pool: set() for pool in partition.pools}
            for name in dirty:
                pool = partition.node_pool.get(name)
                if pool is not None:
                    self._pool_bases[pool].refresh_node(name, nodes[name].plan_clone())
                    pool_dirty[pool].add(name)
        self._partition = partition
        self.last_rebuilt = rebuild
        return snapshot, dirty, partition, self._pool_bases, pool_dirty
