"""Actuation on the control plane's side: counterpart of
``nos_tpu/partitioning/tpu`` (``mig``: spec annotations for the MIG
agent, and the first geometry of a new node) and
``nos_tpu/partitioning/sharing`` (``mps``: the MPS device plugin's config
map and its node label). The planner that decides the geometries stays
unported (ROADMAP.md); callers pass geometries."""
from nos_tpu_torch.partitioning.mig import MigNodeInitializer, MigPartitioner
from nos_tpu_torch.partitioning.mps import MpsPartitioner, plugin_config_from_geometries

__all__ = ["MigNodeInitializer", "MigPartitioner", "MpsPartitioner",
           "plugin_config_from_geometries"]
