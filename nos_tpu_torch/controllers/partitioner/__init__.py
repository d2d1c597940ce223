"""The partitioner controller: counterpart of
``nos_tpu/controllers/partitioner`` (the cold path, polled)."""
from nos_tpu_torch.controllers.partitioner.controller import (
    PartitionerController,
    build_sim_framework,
    could_help,
)

__all__ = ["PartitionerController", "build_sim_framework", "could_help"]
