"""Partitioning on the control plane's side: counterpart of
``nos_tpu/partitioning``.

``core``: the planner and everything it plans with (snapshot, tracker,
verdict cache, actuator). ``mig``: spec annotations for the MIG agent,
the first geometry of a new node and the MIG snapshot taker
(``nos_tpu/partitioning/tpu``). ``mps``: the MPS device plugin's config
map and its node label and the MPS snapshot taker
(``nos_tpu/partitioning/sharing``). ``bench_planner``: the cold-plan
timings on clusters of H100 nodes.
"""
from nos_tpu_torch.partitioning.mig import (
    MigNodeInitializer,
    MigPartitioner,
    MigSnapshotTaker,
    plan_in_flight,
)
from nos_tpu_torch.partitioning.mps import (
    MpsPartitioner,
    MpsSnapshotTaker,
    plugin_config_from_geometries,
)

__all__ = ["MigNodeInitializer", "MigPartitioner", "MigSnapshotTaker", "MpsPartitioner",
           "MpsSnapshotTaker", "plan_in_flight", "plugin_config_from_geometries"]
