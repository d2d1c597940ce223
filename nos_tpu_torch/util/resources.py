"""Resource arithmetic over ``{resource: quantity}`` maps: the port's
trimmed copy of ``nos_tpu/util/resources.py`` (reference
pkg/resource/resource.go:30-146 and pkg/gpu/util/resource.go:28-86).

The reference's pod request is Σ containers ⊔ max of init containers;
the port's pod is already one request map, so ``compute_pod_request``
returns a copy of it. The plain-chip normalization serves the TPU mode
and is left out (a plain ``nvidia.com/gpu`` request is never rewritten
into a slice, ``gpu/node.py``).

The quotas' aggregate resource is the reference nos's
``nos.nebuly.com/gpu-memory``, in GB (``gpu_memory_gb_in``): a MIG
slice ``nvidia.com/mig-<p>`` counts its profile's GB (1g.10gb 10,
3g.40gb 40, 7g.80gb 80), an MPS slice ``nvidia.com/gpu-<N>gb`` counts
N, and a plain ``nvidia.com/gpu`` counts ``gpu_memory_gb``, the
reference's ``NvidiaGpuResourceMemoryGB`` knob (the H100's 80 by
default). The reference's ``nos.nebuly.com/tpu-chips`` has no
counterpart.
"""
from __future__ import annotations

from typing import Dict, Mapping

from nos_tpu_torch.api.v1alpha1.elasticquota import RESOURCE_GPU_MEMORY
from nos_tpu_torch.gpu.annotations import MIG_PROFILE_RE, MPS_PROFILE_RE
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB, KNOWN_GPUS
from nos_tpu_torch.gpu.node import MIG_RESOURCE_PREFIX, MPS_RESOURCE_PREFIX, RESOURCE_GPU

ResourceList = Dict[str, int]

DEFAULT_GPU_MEMORY_GB = KNOWN_GPUS[H100_80GB].memory_gb


def sum_resources(a: Mapping[str, int], b: Mapping[str, int]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def subtract_resources(a: Mapping[str, int], b: Mapping[str, int]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) - v
    return out


def fits(available: Mapping[str, int], request: Mapping[str, int]) -> bool:
    return all(available.get(k, 0) >= v for k, v in request.items())


def compute_pod_request(pod) -> ResourceList:
    """The pod's effective request."""
    return dict(pod.request)


def _slice_gb(name: str) -> int:
    """GB of one MIG or MPS slice resource; 0 for any other resource."""
    if name.startswith(MIG_RESOURCE_PREFIX):
        profile = name[len(MIG_RESOURCE_PREFIX):]
        if MIG_PROFILE_RE.match(profile):
            return int(profile.split(".")[1][:-2])
    elif name.startswith(MPS_RESOURCE_PREFIX):
        profile = name[len(MPS_RESOURCE_PREFIX):]
        if MPS_PROFILE_RE.match(profile):
            return int(profile[:-2])
    return 0


def gpu_memory_gb_in(request: Mapping[str, int],
                     gpu_memory_gb: int = DEFAULT_GPU_MEMORY_GB) -> int:
    """The GB of GPU memory a request amounts to, over plain GPUs and MIG
    and MPS slices."""
    gb = int(request.get(RESOURCE_GPU, 0)) * gpu_memory_gb
    for name, qty in request.items():
        gb += _slice_gb(name) * int(qty)
    return gb


def with_aggregate_gpu_memory(request: Mapping[str, int],
                              gpu_memory_gb: int = DEFAULT_GPU_MEMORY_GB) -> ResourceList:
    """The request with ``nos.nebuly.com/gpu-memory`` added, so a quota
    may count GB whatever GPU resource a pod asks for."""
    out = dict(request)
    memory = gpu_memory_gb_in(request, gpu_memory_gb)
    if memory > 0:
        out[RESOURCE_GPU_MEMORY] = memory
    return out


def gb_per_memory_slice(product: str) -> int:
    """GB of one memory slice of ``product`` (an H100 80GB's 10)."""
    spec = KNOWN_GPUS.get(product, KNOWN_GPUS[H100_80GB])
    return spec.memory_gb // spec.memory_slices


def node_memory_slices(node) -> int:
    """A node's memory slices: its GPUs x its product's slices a GPU."""
    spec = KNOWN_GPUS.get(node.labels.get(GPU_PRODUCT_LABEL, ""), KNOWN_GPUS[H100_80GB])
    return int(node.capacity.get(RESOURCE_GPU, 0)) * spec.memory_slices
