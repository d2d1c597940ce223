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
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Mapping, Optional

from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.node import MigNode
from nos_tpu_torch.kube.store import Node, NodeStore

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
