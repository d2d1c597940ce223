"""The partitioner controller and the multi-node expander: counterpart of
``nos_tpu/controllers/partitioner`` (the cold path, polled)."""
from nos_tpu_torch.controllers.partitioner.controller import (
    PartitionerController,
    build_sim_framework,
    could_help,
)
from nos_tpu_torch.controllers.partitioner.multinode import (
    MultinodeExpander,
    register_multinode_admission,
)

__all__ = ["MultinodeExpander", "PartitionerController", "build_sim_framework", "could_help",
           "register_multinode_admission"]
