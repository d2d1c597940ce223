"""The device access layer: counterpart of ``nos_tpu/device/``.

The reference nos touches hardware through one native component, its
NVML client (pkg/gpu/nvml/client.go), composed with the kubelet's
pod-resources client into mig.Client (SURVEY §2.5, §2.8). Here the seam
is ``MigDeviceClient`` (MIG devices listed, created and destroyed):
``nvml.NvmlMigClient`` over NVIDIA's NVML on a GPU, ``sim.SimMigClient``
over an in-memory pool elsewhere; ``GpuClient`` composes one with a
``PodResourcesClient`` (``podresources.KubeletPodResourcesClient`` over
the kubelet's socket, ``sim.SimPodResourcesClient`` over the node
store), and ``plan.compute_plan`` diffs devices against the spec the
control plane wants. ``sim.DevicePluginAdvertiser`` plays the MIG device
plugin's restart, ``sharing`` the MPS device plugin.
"""
from nos_tpu_torch.device.client import (
    GpuClient,
    MigDeviceClient,
    MigPlacementError,
    create_in_some_order,
)
from nos_tpu_torch.device.plan import CreateOp, MigPlan, compute_plan
from nos_tpu_torch.device.sim import (
    DevicePluginAdvertiser,
    SimDevicePlugin,
    SimMigClient,
    SimMigPool,
    SimPodResourcesClient,
)
from nos_tpu_torch.device.types import DeviceStatus, MigDevice, SharedSlice, group_geometries

__all__ = [
    "CreateOp", "DevicePluginAdvertiser", "DeviceStatus", "GpuClient", "MigDevice",
    "MigDeviceClient", "MigPlacementError", "MigPlan", "SharedSlice", "SimDevicePlugin",
    "SimMigClient", "SimMigPool", "SimPodResourcesClient", "compute_plan",
    "create_in_some_order", "group_geometries",
]
