"""Training and sequence / data parallelism over ``torch.distributed``.

What runs: ``make_train_step`` on one device or over a ``DeviceMesh``
with axes ``dp`` and ``sp`` (``tp`` of size 1); ring attention (the
flash kernels in block mode, or the plain ring) and Ulysses attention
over ``sp``; the gang bootstrap (``distributed.py``), the mesh builders
(``mesh.py``), the collectives (``comm.py``) and the token layout
(``sharding.py:llama_data_sharding``). The attention functions are
imported from their modules (``parallel.ring_attention``,
``parallel.ulysses``), whose names they share.

Still missing, each raising NotImplementedError naming ROADMAP Queue 1
item 9 where the reference has an entry point: tensor parallelism and
FSDP (``sharding.llama_param_sharding`` / ``llama_quantized_sharding``,
``train.optimizer_state_sharding``, ``mesh.mesh_for_slice``), expert
parallelism (``moe_mlp``'s ``mesh``), LoRA training and
the ``Engine`` under a mesh; ``serve/sharded.py``, ``parallel/pipeline.py``
and ``parallel/checkpoint.py`` have no counterpart yet.
"""

from nos_tpu_torch.parallel.mesh import default_training_mesh, mesh_from_devices
from nos_tpu_torch.parallel.sharding import llama_data_sharding
from nos_tpu_torch.parallel.train import make_train_step

__all__ = [
    "default_training_mesh",
    "llama_data_sharding",
    "make_train_step",
    "mesh_from_devices",
]
