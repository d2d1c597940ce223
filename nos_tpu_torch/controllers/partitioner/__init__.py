"""The partitioner controller, its watch-fed state controllers and the
multi-node expander: counterpart of ``nos_tpu/controllers/partitioner``."""
from nos_tpu_torch.controllers.partitioner.controller import (
    PartitionerController,
    build_sim_framework,
    could_help,
)
from nos_tpu_torch.controllers.partitioner.multinode import (
    MultinodeExpander,
    register_multinode_admission,
)
from nos_tpu_torch.controllers.partitioner.node_controller import (
    StateNodeController,
    add_state_controllers,
)
from nos_tpu_torch.controllers.partitioner.pod_controller import StatePodController

__all__ = ["MultinodeExpander", "PartitionerController", "StateNodeController",
           "StatePodController", "add_state_controllers", "build_sim_framework", "could_help",
           "register_multinode_admission"]
