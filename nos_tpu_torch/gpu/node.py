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

For the planner (``partitioning/core``) a node also answers
``has_free_capacity``, makes a ``plan_clone`` for the snapshot's fork
journal (the GPUs' used / free copied, nothing else), rewrites a node's
allocatable to its current geometry for the scheduler's simulation
(``sim_allocatable``, TpuNode.to_sim_node / SharingNode.to_sim_node) and,
for MIG, re-derives its used / free split from the pods bound to it
(``rebuild_usage_from_pods``, TpuNode's).
"""
from __future__ import annotations

import copy
import re
from typing import Dict, Iterable, List, Mapping, Optional

from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.geometry import Geometry, geometry_add
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS, memory_gb_per_gpu
from nos_tpu_torch.gpu.mig import MigGpu
from nos_tpu_torch.gpu.slicing import SharedGpu

RESOURCE_GPU = "nvidia.com/gpu"
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"
MPS_RESOURCE_PREFIX = "nvidia.com/gpu-"

# How a node's GPUs are shared (nos_tpu/api/v1alpha1/labels.py:10); the
# MPS agent refuses to report on a node labelled "mig"
PARTITIONING_LABEL = "nos.nebuly.com/gpu-partitioning"
PARTITIONING_MIG = "mig"
PARTITIONING_MPS = "mps"


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

    def has_free_capacity(self) -> bool:
        return self.consistent and any(g.has_free_capacity() for g in self.gpus)

    def plan_clone(self):
        clone = copy.copy(self)
        clone.gpus = [g.plan_clone() for g in self.gpus]
        return clone

    def sim_allocatable(self, allocatable: Mapping[str, int]) -> Dict[str, int]:
        """``allocatable`` with this mode's slices and the whole GPUs
        replaced by what the current geometry advertises."""
        out = {k: v for k, v in allocatable.items()
               if k != RESOURCE_GPU and self._profile(k) is None}
        for name, qty in self.scalar_resources().items():
            out[name] = out.get(name, 0) + qty
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

    _profile_re = annot.MIG_PROFILE_RE
    _prefix = MIG_RESOURCE_PREFIX

    def _gpu(self, index, used, free) -> MigGpu:
        return MigGpu(index, self.product, used=used, free=free)

    def rebuild_usage_from_pods(self, requests: Iterable[Mapping[str, int]]) -> None:
        """Re-derive the used / free split from the requests of the pods
        bound here (pending or running), keeping only the reported
        geometry: the reporter's split lags binds, and planning against a
        stale "free" could carve away an instance a just-bound pod holds.
        A profile with no instance left to hold it marks the node
        inconsistent (mid-change) until the agent reports again."""
        demand: Geometry = {}
        for request in requests:
            for name, qty in request.items():
                profile = self._profile(name)
                if profile is not None:
                    demand[profile] = demand.get(profile, 0) + int(qty)
        for gpu in self.gpus:
            gpu.free = geometry_add(gpu.free, gpu.used)
            gpu.used = {}
        for profile in sorted(demand):
            for _ in range(demand[profile]):
                if not any(gpu.allocate(profile) for gpu in self.gpus):
                    self.consistent = False
                    return


class MpsNode(_GpuNode):
    """A node whose GPUs are shared through MPS, in memory slices."""

    _profile_re = annot.MPS_PROFILE_RE
    _prefix = MPS_RESOURCE_PREFIX

    def _gpu(self, index, used, free) -> SharedGpu:
        return SharedGpu(index, memory_gb_per_gpu(self.product), used=used, free=free)

    def sim_allocatable(self, allocatable: Mapping[str, int]) -> Dict[str, int]:
        """Slices advertised; a GPU holding any slice is no longer
        requestable whole."""
        out = super().sim_allocatable(allocatable)
        out[RESOURCE_GPU] = sum(1 for g in self.gpus if not g.geometry)
        return out
