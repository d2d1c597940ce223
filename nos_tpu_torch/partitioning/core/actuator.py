"""Actuator: applies a plan through a mode's partitioner.

Counterpart of ``nos_tpu/partitioning/core/actuator.py`` (reference
internal/partitioning/core/actuator.go:39-66): diff the desired state
against the current one, skip when they are equal or the desired state
is empty, else hand each changed node's geometries (GPU index →
{profile: count}) to ``MigPartitioner.apply_partitioning`` (spec
annotations for the MIG agent) or ``MpsPartitioner``'s (the device
plugin's config map and label). Each node is applied in an
``actuator.apply_node`` span, linked under ``("reconfig", node, plan
id)``: the MIG agent picks the plan up later, out of this context, and
parents its ``migagent.reconfig`` span on that link, so the re-carve
lands in the plan's trace.
"""
from __future__ import annotations

import logging
from typing import Dict, Mapping, Protocol

from nos_tpu_torch.gpu.node import MIG_RESOURCE_PREFIX, MPS_RESOURCE_PREFIX
from nos_tpu_torch.partitioning.core.partition_state import (
    NodePartitioning,
    PartitioningPlan,
    PartitioningState,
    node_key,
    partitioning_state_equal,
)
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.partitioning")


class Partitioner(Protocol):
    def apply_partitioning(self, node_name: str, plan_id: str,
                           geometries: Mapping[int, Mapping[str, int]]) -> None: ...


def _profile(resource: str) -> str:
    for prefix in (MIG_RESOURCE_PREFIX, MPS_RESOURCE_PREFIX):
        if resource.startswith(prefix):
            return resource[len(prefix):]
    raise ValueError(f"{resource!r} is not a MIG or MPS slice resource")


def node_geometries(np: NodePartitioning) -> Dict[int, Dict[str, int]]:
    """GPU index → {profile: count}: the partitioners' input."""
    return {g.gpu_index: {_profile(name): qty for name, qty in g.resources.items()}
            for g in np.gpus}


class Actuator:
    def __init__(self, partitioner: Partitioner) -> None:
        self.partitioner = partitioner

    def apply(self, current: PartitioningState, plan: PartitioningPlan) -> int:
        """Apply the per-node diff; the number of nodes actuated."""
        desired = plan.desired_state
        if not desired or partitioning_state_equal(current, desired):
            return 0
        applied = 0
        for node_name, np in sorted(desired.items()):
            if node_key(current.get(node_name, NodePartitioning())) == node_key(np):
                continue
            with TRACER.span("actuator.apply_node", node=node_name, plan_id=plan.id) as span:
                TRACER.link(("reconfig", node_name, plan.id), span)
                self.partitioner.apply_partitioning(node_name, plan.id, node_geometries(np))
            applied += 1
        return applied
