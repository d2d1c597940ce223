"""Per-mode slice resource codecs.

Counterpart of ``nos_tpu/partitioning/core/codec.py``: the snapshot, the
tracker and the planner are mode-agnostic, and a codec says which
resources a mode serves, how a profile is named as a resource, and how a
request draws on a pool of free slices. ``TpuSliceCodec`` (``:34``)
becomes ``MigSliceCodec`` over ``nvidia.com/mig-<profile>``,
``SharedSliceCodec`` (``:80``) becomes ``MpsSliceCodec`` over
``nvidia.com/gpu-<N>gb``. Neither normalizes a plain ``nvidia.com/gpu``
request (``gpu/node.py``), so neither tracks it, and a request draws
only on free slices of its own profile: a 20 GB request never takes a
40 GB slice, as the reference's shared codec never does.

``effective_size`` is the planner's measure of a slice, the reference's
chip count: a MIG profile's memory slices (a 3g.40gb counts 4), an MPS
slice's GB over 10.
"""
from __future__ import annotations

from typing import Protocol

from nos_tpu_torch.device.sharing import is_mps_resource
from nos_tpu_torch.gpu.annotations import MIG_PROFILE_RE
from nos_tpu_torch.gpu.known import mig_profile
from nos_tpu_torch.gpu.node import (
    MIG_RESOURCE_PREFIX,
    MPS_RESOURCE_PREFIX,
    mig_resource,
    mps_resource,
)
from nos_tpu_torch.gpu.slicing import profile_gb
from nos_tpu_torch.util.resources import ResourceList


def is_mig_resource(name: str) -> bool:
    """'nvidia.com/mig-3g.40gb' and the like."""
    return (name.startswith(MIG_RESOURCE_PREFIX)
            and bool(MIG_PROFILE_RE.match(name[len(MIG_RESOURCE_PREFIX):])))


def profile_size(profile: str) -> float:
    """A profile's effective size: memory slices of a MIG profile, GB / 10
    of an MPS slice."""
    if MIG_PROFILE_RE.match(profile):
        return mig_profile(profile).memory_slices
    return profile_gb(profile) / 10


def effective_size(resource: str) -> float:
    """A slice resource's effective size; 0 for any other resource."""
    if is_mig_resource(resource):
        return profile_size(resource[len(MIG_RESOURCE_PREFIX):])
    if is_mps_resource(resource):
        return profile_size(resource[len(MPS_RESOURCE_PREFIX):])
    return 0


def is_slice_resource(name: str) -> bool:
    return is_mig_resource(name) or is_mps_resource(name)


class SliceCodec(Protocol):
    def is_tracked(self, name: str) -> bool: ...

    def resource(self, profile: str) -> str: ...

    def take_from_pool(self, pool: ResourceList, request: ResourceList) -> ResourceList: ...


def _take_exact(tracked, pool: ResourceList, request: ResourceList) -> ResourceList:
    """Serve the request's tracked resources from ``pool`` (mutating it),
    profile by profile; what is left lacking."""
    lacking: ResourceList = {}
    for name, qty in request.items():
        if tracked(name):
            take = min(qty, pool.get(name, 0))
            pool[name] = pool.get(name, 0) - take
            if qty - take > 0:
                lacking[name] = qty - take
    return lacking


class MigSliceCodec:
    """MIG instances, ``nvidia.com/mig-<profile>``."""

    def is_tracked(self, name: str) -> bool:
        return is_mig_resource(name)

    def resource(self, profile: str) -> str:
        return mig_resource(profile)

    def take_from_pool(self, pool: ResourceList, request: ResourceList) -> ResourceList:
        return _take_exact(is_mig_resource, pool, request)


class MpsSliceCodec:
    """MPS memory slices, ``nvidia.com/gpu-<N>gb``."""

    def is_tracked(self, name: str) -> bool:
        return is_mps_resource(name)

    def resource(self, profile: str) -> str:
        return mps_resource(profile)

    def take_from_pool(self, pool: ResourceList, request: ResourceList) -> ResourceList:
        return _take_exact(is_mps_resource, pool, request)

