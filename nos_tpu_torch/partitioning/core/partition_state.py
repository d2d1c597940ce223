"""Partitioning state: what the planner decides and the actuator applies.

Counterpart of ``nos_tpu/partitioning/core/partition_state.py`` (reference
internal/partitioning/state/partitioning.go:24-56): a GPU's partitioning
is its index and its slice resources (``nvidia.com/mig-<profile>`` or
``nvidia.com/gpu-<N>gb`` → count), a node's is its GPUs', and a
``PartitioningState`` maps node names to them with unordered equality
(GPU order and empty GPUs ignored).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from nos_tpu_torch.util.resources import ResourceList


@dataclass
class GpuPartitioning:
    gpu_index: int
    resources: ResourceList = field(default_factory=dict)  # slice resource → count


@dataclass
class NodePartitioning:
    gpus: List[GpuPartitioning] = field(default_factory=list)


PartitioningState = Dict[str, NodePartitioning]


@dataclass
class PartitioningPlan:
    desired_state: PartitioningState
    id: str


def node_key(np: NodePartitioning) -> tuple:
    return tuple(sorted((g.gpu_index, tuple(sorted(g.resources.items())))
                        for g in np.gpus if g.resources))


def partitioning_state_equal(a: PartitioningState, b: PartitioningState) -> bool:
    """Unordered equality, empty GPU entries ignored."""
    return all(node_key(a.get(k, NodePartitioning())) == node_key(b.get(k, NodePartitioning()))
               for k in set(a) | set(b))


def partitioning_state_to_dict(state: PartitioningState) -> dict:
    """node → GPU index (a string key) → resources: the plan record's form."""
    return {node: {str(g.gpu_index): dict(g.resources) for g in np.gpus}
            for node, np in state.items()}


def partitioning_state_from_dict(doc: dict) -> PartitioningState:
    """``partitioning_state_to_dict``'s inverse."""
    return {node: NodePartitioning(gpus=[GpuPartitioning(int(index), dict(resources))
                                         for index, resources in gpus.items()])
            for node, gpus in doc.items()}
