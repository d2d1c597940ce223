"""Training and multi-device execution over ``torch.distributed``.

What runs: ``make_train_step`` on one device or over a ``DeviceMesh``
with axes ``dp``, ``sp``, ``tp`` and ``ep`` (FSDP over dp,
Megatron-style tensor parallelism over tp, the sequence over sp, a MoE
model's experts over ep); the GPipe schedule over ``pp``
(``pipeline.py``: ``stack_layer_params``, ``pipeline_param_sharding``,
``pipeline_llama_forward`` / ``pipeline_llama_loss``); ring attention
(the flash kernels in block mode, or the plain ring) and Ulysses
attention over ``sp``, on the rank's heads under tp; the gang bootstrap
(``distributed.py``), the mesh constructors (``mesh.py``:
``default_training_mesh``, ``mesh_for_slice``), the collectives and the
tensor-parallel autograd pieces (``comm.py``), the sharding rules and
the rank's shards (``sharding.py``: ``llama_param_sharding``,
``llama_quantized_sharding``, ``moe_param_sharding``, ``shard_params``,
``gather_params``, ``llama_data_sharding``),
``train.optimizer_state_sharding``, and checkpoints that reshard on
restore (``checkpoint.py``). The attention functions are imported from
their modules (``parallel.ring_attention``, ``parallel.ulysses``), whose
names they share.
"""

from nos_tpu_torch.parallel.checkpoint import (
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from nos_tpu_torch.parallel.mesh import (
    default_training_mesh,
    mesh_for_slice,
    mesh_from_devices,
)
from nos_tpu_torch.parallel.pipeline import (
    pipeline_llama_forward,
    pipeline_llama_loss,
    pipeline_param_sharding,
    stack_layer_params,
)
from nos_tpu_torch.parallel.sharding import (
    gather_params,
    llama_data_sharding,
    llama_param_sharding,
    llama_quantized_sharding,
    moe_param_sharding,
    shard_params,
)
from nos_tpu_torch.parallel.train import make_train_step, optimizer_state_sharding

__all__ = [
    "Checkpointer",
    "default_training_mesh",
    "gather_params",
    "latest_step",
    "llama_data_sharding",
    "llama_param_sharding",
    "llama_quantized_sharding",
    "make_train_step",
    "mesh_for_slice",
    "mesh_from_devices",
    "moe_param_sharding",
    "optimizer_state_sharding",
    "pipeline_llama_forward",
    "pipeline_llama_loss",
    "pipeline_param_sharding",
    "restore_checkpoint",
    "save_checkpoint",
    "shard_params",
    "stack_layer_params",
]
