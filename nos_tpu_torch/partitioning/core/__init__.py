"""The partitioning engine: counterpart of ``nos_tpu/partitioning/core``.

The state types (``partition_state``), the per-mode resource codecs
(``codec``), the partitioner's cluster cache (``state``), the snapshot
with its fork journal (``snapshot``), the pending pods' lack
(``tracker``), the simulation's verdict cache (``verdict_cache``), the
planner (``planner``), the actuator (``actuator``), pool-sharded
planning (``pools``), the pool worker processes (``procpool``) and the
warm-state codec with the workers' frames (``snapcodec``). None of these
modules imports torch: the planner is host code.
"""
from nos_tpu_torch.partitioning.core.actuator import Actuator, node_geometries
from nos_tpu_torch.partitioning.core.codec import MigSliceCodec, MpsSliceCodec
from nos_tpu_torch.partitioning.core.partition_state import (
    GpuPartitioning,
    NodePartitioning,
    PartitioningPlan,
    PartitioningState,
    partitioning_state_equal,
)
from nos_tpu_torch.partitioning.core.planner import Planner, sort_candidate_pods
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.partitioning.core.state import ClusterState
from nos_tpu_torch.partitioning.core.tracker import SliceTracker
from nos_tpu_torch.partitioning.core.verdict_cache import VerdictCache

__all__ = [
    "Actuator", "ClusterSnapshot", "ClusterState", "GpuPartitioning", "MigSliceCodec",
    "MpsSliceCodec", "NodePartitioning", "PartitioningPlan", "PartitioningState", "Planner",
    "SliceTracker", "SnapshotNode", "VerdictCache", "node_geometries",
    "partitioning_state_equal", "sort_candidate_pods",
]
