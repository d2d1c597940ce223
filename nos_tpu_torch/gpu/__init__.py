"""The GPU domain model: counterpart of ``nos_tpu/tpu/``.

MIG geometry on the H100-80GB (``known``, ``geometry``, ``mig``), MPS
memory slices (``slicing``), the spec / status annotation codec
(``annotations``) and the nodes built from plain mappings (``node``).
Nothing here touches a GPU: ``nos_tpu_torch.device`` does.
"""
from nos_tpu_torch.gpu.known import (
    GPU_PRODUCT_LABEL,
    H100_80GB,
    KNOWN_GPUS,
    allowed_geometries,
    memory_gb_per_gpu,
    profile_for_gb,
    set_known_geometries,
)
from nos_tpu_torch.gpu.mig import MigGpu
from nos_tpu_torch.gpu.node import MigNode, MpsNode, mig_resource, mps_resource
from nos_tpu_torch.gpu.slicing import SharedGpu

__all__ = [
    "GPU_PRODUCT_LABEL", "H100_80GB", "KNOWN_GPUS", "MigGpu", "MigNode", "MpsNode",
    "SharedGpu", "allowed_geometries", "memory_gb_per_gpu", "mig_resource",
    "mps_resource", "profile_for_gb", "set_known_geometries",
]
