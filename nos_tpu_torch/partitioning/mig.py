"""MIG actuation: counterparts of ``nos_tpu/partitioning/tpu/partitioner.py:22``
(``TpuPartitioner``, reference internal/partitioning/mig/partitioner.go:43-94)
and ``initializer.py:25`` (``TpuNodeInitializer``, reference
internal/partitioning/mig/initializer.go:36-87).

``MigPartitioner.apply_partitioning(node, plan_id, geometries)`` replaces
the node's ``spec-gpu-*`` annotations with the geometries (GPU index →
{profile: count}) and writes the plan id; the node's MIG agent takes it
from there. ``MigNodeInitializer`` gives a node that reports no geometry
yet the fewest-slices one (``MigGpu.init_geometry``: each GPU a whole
7g.80gb), so its instances become visible at once.

``MigSnapshotTaker`` is the counterpart of
``nos_tpu/partitioning/tpu/snapshot_taker.py`` (reference
internal/partitioning/mig/snapshot_taker.go:31-53): nodes labelled
``nos.nebuly.com/gpu-partitioning=mig`` become ``MigNode``s whose used /
free split is re-derived from the pods bound to them, frozen while
their agent has not acknowledged the spec plan (``plan_in_flight``).
A GPU whose acknowledged spec geometry differs from what its agent
reports refused that geometry (``refused_geometries``). The taker keeps
each GPU's refusals while its reported geometry and used split stay the
same, and its ``MigGpu`` skips them all, so the planner does not re-plan
geometries a used instance's placement forbids on every batch
(ROADMAP.md, fault F4). ``take_in_refusals`` seeds a taker with
another's refusals for a node: a pool worker's taker gets the parent's
from the wire (``partitioning/core/procpool.py``).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, MigNode
from nos_tpu_torch.kube.store import Node, NodeStore, Pod
from nos_tpu_torch.partitioning.core.codec import MigSliceCodec
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.partitioning.core.state import ClusterState

log = logging.getLogger("nos_tpu_torch.partitioning.mig")


class MigPartitioner:
    def __init__(self, store: NodeStore) -> None:
        self.store = store

    def apply_partitioning(self, node_name: str, plan_id: str,
                           geometries: Mapping[int, Mapping[str, int]]) -> None:
        desired = annot.spec_from_geometries(geometries)
        node = self.store.try_get("Node", node_name)
        if node is None:
            log.warning("apply_partitioning: node %s vanished", node_name)
            return
        patch: Dict[str, Optional[str]] = dict(annot.strip_spec_annotations(node.annotations))
        patch.update(desired)
        patch[annot.SPEC_PARTITIONING_PLAN] = plan_id
        self.store.patch_annotations("Node", node_name, "", patch)
        log.info("apply_partitioning: node %s plan %s -> %d spec annotations", node_name,
                 plan_id, len(desired))


def mig_node(node: Node) -> MigNode:
    return MigNode(node.name, node.labels, node.capacity, node.annotations)


class MigNodeInitializer:
    def __init__(self, partitioner: MigPartitioner, plan_id_fn: Callable[[], str]) -> None:
        self.partitioner = partitioner
        self.plan_id_fn = plan_id_fn

    @staticmethod
    def is_initialized(node: Node) -> bool:
        """A node is initialized once it has any spec or status geometry
        (reference core/util.go:76)."""
        spec, status = annot.parse_node_annotations(node.annotations)
        return bool(spec or status)

    def init_node_partitioning(self, node: Node) -> bool:
        """Write the first geometry of a node that has none; False when
        there was nothing to do (not a known GPU node, or initialized)."""
        gpu_node = mig_node(node)
        changed = False
        for gpu in gpu_node.gpus:
            changed |= gpu.init_geometry()
        if not changed:
            return False
        self.partitioner.apply_partitioning(node.name, self.plan_id_fn(), gpu_node.geometry())
        log.info("initialized MIG node %s", node.name)
        return True


def plan_in_flight(node: Node) -> bool:
    """True while the node's agent has not acknowledged its spec plan: its
    geometry is mid-change and must not be carved again."""
    spec_plan = node.annotations.get(annot.SPEC_PARTITIONING_PLAN)
    return bool(spec_plan) and spec_plan != node.annotations.get(
        annot.STATUS_PARTITIONING_PLAN)


def refused_geometries(node: Node) -> Dict[int, Dict[str, int]]:
    """GPU → the spec geometry its agent acknowledged but did not create
    (the reported geometry differs), once the node's plan is
    acknowledged."""
    if plan_in_flight(node) or not node.annotations.get(annot.SPEC_PARTITIONING_PLAN):
        return {}
    spec, status = annot.parse_node_annotations(node.annotations)
    wanted = annot.spec_geometries([s for s in spec if annot.MIG_PROFILE_RE.match(s.profile)])
    have = annot.status_geometries([s for s in status if annot.MIG_PROFILE_RE.match(s.profile)])
    return {gpu: geometry for gpu, geometry in wanted.items()
            if geometry != have.get(gpu, {})}


def cluster_view(state: ClusterState) -> Dict[str, Tuple[Node, List[Pod]]]:
    """node name → (node, the pods bound there, pending or running), from
    the controller's state as its last ``sync`` left it."""
    return {name: (info.node, list(info.pods)) for name, info in state.read_view().items()}


class MigSnapshotTaker:
    def __init__(self) -> None:
        # node → (GPU, reported geometry, reported used) → the geometries
        # its agent refused in that state
        self._refusals: Dict[str, Dict[tuple, set]] = {}

    def _note_refusals(self, node: Node, mig: MigNode) -> None:
        """Record the node's refusals and hand each GPU those of its
        reported state (before the split is re-derived from pods); a state
        no GPU of the node reports any more takes its refusals with it."""
        refused = refused_geometries(node)
        before = self._refusals.get(node.name, {})
        kept: Dict[tuple, set] = {}
        for gpu in mig.gpus:
            key = (gpu.index, frozenset(gpu.geometry.items()), frozenset(gpu.used.items()))
            refusals = before.get(key, set())
            if gpu.index in refused:
                refusals = refusals | {frozenset(refused[gpu.index].items())}
            if refusals:
                kept[key] = refusals
            gpu.refused = refusals
        self._refusals[node.name] = kept

    def take_in_refusals(self, node: Node, refusals: Mapping[int, list]) -> None:
        """Take another taker's refusals of ``node`` (GPU index → the refused
        geometries as item lists, ``snapcodec.node_refusals``) as this
        one's, keyed by the GPUs' reported state: a pool worker's taker then
        holds what the parent's held, and ``take_snapshot_node`` hands them
        on."""
        mig = mig_node(node)
        kept = self._refusals.setdefault(node.name, {})
        for gpu in mig.gpus:
            key = (gpu.index, frozenset(gpu.geometry.items()), frozenset(gpu.used.items()))
            if refusals.get(gpu.index):
                kept[key] = {frozenset((p, n) for p, n in g) for g in refusals[gpu.index]}
            else:
                kept.pop(key, None)

    def take_snapshot_node(self, node: Node, pods: List[Pod]) -> Optional[SnapshotNode]:
        """The node's snapshot entry, or None when it is not a MIG node:
        the constructor of both the whole take and the incremental
        maintainer's refresh of one node."""
        if node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
            return None
        mig = mig_node(node)
        if not mig.gpus:
            return None
        self._note_refusals(node, mig)
        # plan against the live bindings, not the reporter's split
        mig.rebuild_usage_from_pods(p.request for p in pods)
        return SnapshotNode(partitionable=mig, pods=list(pods), node=node,
                            frozen=plan_in_flight(node))

    def take_snapshot(self, state: ClusterState) -> ClusterSnapshot:
        nodes: Dict[str, SnapshotNode] = {}
        for name, (node, pods) in cluster_view(state).items():
            snap_node = self.take_snapshot_node(node, pods)
            if snap_node is not None:
                nodes[name] = snap_node
        # a node gone: its refusals go with it
        self._refusals = {k: v for k, v in self._refusals.items() if k in nodes}
        return ClusterSnapshot(nodes, codec=MigSliceCodec())
