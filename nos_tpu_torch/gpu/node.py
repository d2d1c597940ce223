"""MigNode and MpsNode: a partitionable GPU node, from plain mappings.

Counterparts of ``nos_tpu/tpu/node.py:25`` (``TpuNode``, the reference's
``mig.Node``, pkg/gpu/mig/node.go:26-222) and ``nos_tpu/tpu/sharing.py:164``
(``SharingNode``, the reference's ``slicing.Node``,
pkg/gpu/slicing/node.go:32-215). The port has no kube object model: a
node is its labels (the GPU product, ``nvidia.com/gpu.product``), its
capacity (``nvidia.com/gpu``: how many GPUs) and its annotations (the
status the node's agent reported), and a pod is its request,
``{resource: quantity}``. MIG instances are ``nvidia.com/mig-<profile>``,
MPS slices ``nvidia.com/gpu-<N>gb``.

Unlike TpuNode, a plain ``nvidia.com/gpu`` request is not rewritten into
a slice: a pod asking for whole GPUs does not fit a node's MIG instances
or MPS slices, and ``add_pod`` refuses it.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.geometry import Geometry, geometry_add
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS, memory_gb_per_gpu
from nos_tpu_torch.gpu.mig import MigGpu
from nos_tpu_torch.gpu.slicing import SharedGpu

RESOURCE_GPU = "nvidia.com/gpu"
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"
MPS_RESOURCE_PREFIX = "nvidia.com/gpu-"
_MIG_PROFILE_RE = re.compile(r"^\d+g\.\d+gb$")
_MPS_PROFILE_RE = re.compile(r"^\d+gb$")


def mig_resource(profile: str) -> str:
    """'3g.40gb' -> 'nvidia.com/mig-3g.40gb'."""
    return MIG_RESOURCE_PREFIX + profile


def mps_resource(profile: str) -> str:
    """'20gb' -> 'nvidia.com/gpu-20gb'."""
    return MPS_RESOURCE_PREFIX + profile


class _GpuNode:
    """What MigNode and MpsNode share: GPUs visited in index order, each
    with ``used`` / ``free`` geometries, ``update_geometry_for`` and
    ``allocate``."""

    _profile_re: re.Pattern
    _prefix: str

    def __init__(self, name: str, labels: Mapping[str, str], capacity: Mapping[str, int],
                 annotations: Mapping[str, str]) -> None:
        self.name = name
        self.product = labels.get(GPU_PRODUCT_LABEL, "")
        self.gpus: List = []
        # False when status annotations name GPUs this node does not have
        # (stale agent state): neither carve nor place on such a node
        self.consistent = True
        count = int(capacity.get(RESOURCE_GPU, 0))
        if self.product not in KNOWN_GPUS or count <= 0:
            return
        _, status = annot.parse_node_annotations(annotations)
        free: Dict[int, Geometry] = {}
        used: Dict[int, Geometry] = {}
        for s in status:
            if not self._profile_re.match(s.profile):
                continue  # the other mode's annotation: not ours to model
            if s.gpu_index >= count:
                self.consistent = False
                continue
            target = free if s.status == annot.STATUS_FREE else used
            gpu = target.setdefault(s.gpu_index, {})
            gpu[s.profile] = gpu.get(s.profile, 0) + s.quantity
        self.gpus = [self._gpu(i, used.get(i, {}), free.get(i, {})) for i in range(count)]

    def _gpu(self, index: int, used: Geometry, free: Geometry):
        raise NotImplementedError

    def _profile(self, resource: str) -> Optional[str]:
        if not resource.startswith(self._prefix):
            return None
        profile = resource[len(self._prefix):]
        return profile if self._profile_re.match(profile) else None

    # ----------------------------------------------------------- queries

    def geometry(self) -> Dict[int, Geometry]:
        """GPU index → total geometry (used + free)."""
        return {g.index: g.geometry for g in self.gpus}

    def free_slices(self) -> Geometry:
        out: Geometry = {}
        for g in self.gpus:
            out = geometry_add(out, g.free)
        return out

    def scalar_resources(self) -> Dict[str, int]:
        """The resources this node's geometry exposes: what the device
        plugin advertises (reference node.go:173-195)."""
        out: Dict[str, int] = {}
        for g in self.gpus:
            for profile, qty in g.geometry.items():
                name = self._prefix + profile
                out[name] = out.get(name, 0) + qty
        return out

    # ---------------------------------------------------------- mutation

    def update_geometry_for(self, lacking: Mapping[str, int]) -> bool:
        """Re-carve GPUs so the cluster lacks fewer of `lacking` (slice
        resources → quantity). GPUs are visited in order, each serving
        whatever is still lacking after its predecessors (reference
        pkg/gpu/mig/node.go:145-171)."""
        if not self.consistent:
            return False
        remaining: Geometry = {}
        for name, qty in lacking.items():
            profile = self._profile(name)
            if profile is not None:
                remaining[profile] = int(qty)
        if not remaining:
            return False
        changed = False
        for gpu in self.gpus:
            if not remaining:
                break
            if gpu.update_geometry_for(remaining):
                changed = True
            for profile in list(remaining):
                remaining[profile] -= gpu.free.get(profile, 0)
                if remaining[profile] <= 0:
                    del remaining[profile]
        return changed

    def add_pod(self, request: Mapping[str, int]) -> bool:
        """Take free slices for a pod's request; returns False, leaving the
        node untouched, when it does not fit."""
        if int(request.get(RESOURCE_GPU, 0)) > 0:
            return False
        needed: Geometry = {}
        for name, qty in request.items():
            profile = self._profile(name)
            if profile is not None:
                needed[profile] = int(qty)
        if not needed:
            return True
        plan: List[tuple] = []
        free = {g.index: dict(g.free) for g in self.gpus}
        for profile, qty in needed.items():
            for _ in range(qty):
                for g in self.gpus:
                    if free[g.index].get(profile, 0) > 0:
                        free[g.index][profile] -= 1
                        plan.append((g, profile))
                        break
                else:
                    return False
        for gpu, profile in plan:
            gpu.allocate(profile)
        return True


class MigNode(_GpuNode):
    """A node whose GPUs are carved into MIG instances."""

    _profile_re = _MIG_PROFILE_RE
    _prefix = MIG_RESOURCE_PREFIX

    def _gpu(self, index, used, free) -> MigGpu:
        return MigGpu(index, self.product, used=used, free=free)


class MpsNode(_GpuNode):
    """A node whose GPUs are shared through MPS, in memory slices."""

    _profile_re = _MPS_PROFILE_RE
    _prefix = MPS_RESOURCE_PREFIX

    def _gpu(self, index, used, free) -> SharedGpu:
        return SharedGpu(index, memory_gb_per_gpu(self.product), used=used, free=free)
