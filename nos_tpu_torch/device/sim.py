"""Simulated MIG hardware and its device plugin: counterpart of
``nos_tpu/device/sim.py``, ``:23`` (``SimDevicePool``), ``:61``
(``SimTpuDeviceClient``), ``:77`` (``SimPodResourcesClient``) and
``:118`` / ``:166`` (``DevicePluginAdvertiser``, ``SimDevicePlugin``).

SimMigPool is each node's "silicon": it keeps the MIG devices of every
GPU and places a new GPU instance as NVML does here, at the first free
start the H100 table allows for its profile, within the seven compute
slices and the profile's instance limit, so a create that NVML would
refuse fails here too (``MigPlacementError``) and the search over
creation orders runs on the CPU. SimMigClient is one node's view of the
pool, with NvmlMigClient's interface.

SimPodResourcesClient plays the kubelet's allocation records: the pods
bound to the node, pending or running, hold MIG devices of the profiles
they ask for, in sorted uuid order. DevicePluginAdvertiser plays a
device-plugin restart: it re-advertises the node's MIG instances in its
allocatable (``nvidia.com/mig-<profile>``), ``nvidia.com/gpu`` becoming
the GPUs that hold no MIG instance; the capacity stays the physical GPU
count.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List

from nos_tpu_torch.device.client import MigPlacementError, create_in_some_order
from nos_tpu_torch.device.types import MigDevice, device_geometry
from nos_tpu_torch.gpu.known import H100_80GB, KNOWN_GPUS, mig_profile
from nos_tpu_torch.gpu.node import MIG_RESOURCE_PREFIX, RESOURCE_GPU, mig_resource
from nos_tpu_torch.kube.store import NodeStore, PodPhase


class SimMigPool:
    """In-memory MIG devices per node and GPU (the 'hardware'). Every GPU
    is an H100 80GB."""

    def __init__(self) -> None:
        self.spec = KNOWN_GPUS[H100_80GB]
        self._lock = threading.RLock()
        # node -> uuid -> MigDevice (status field unused here)
        self._devices: Dict[str, Dict[str, MigDevice]] = {}
        self._counter = itertools.count(1)

    def get(self, node_name: str) -> List[MigDevice]:
        with self._lock:
            return list(self._devices.get(node_name, {}).values())

    def _place(self, node_name: str, gpu_index: int, profile: str) -> MigDevice:
        p = mig_profile(profile)
        on_gpu = [d for d in self._devices.get(node_name, {}).values()
                  if d.gpu_index == gpu_index]
        taken = set()
        for d in on_gpu:
            taken.update(range(d.start, d.start + d.size))
        compute = sum(mig_profile(d.profile).compute_slices for d in on_gpu)
        count = sum(d.profile == profile for d in on_gpu)
        if (compute + p.compute_slices <= self.spec.compute_slices
                and count < p.max_instances):
            for start in p.starts:
                if not taken & set(range(start, start + p.memory_slices)):
                    uuid = f"MIG-sim-{node_name}-{gpu_index}-{next(self._counter)}"
                    device = MigDevice(uuid, gpu_index, profile, start, p.memory_slices)
                    self._devices.setdefault(node_name, {})[uuid] = device
                    return device
        raise MigPlacementError(
            f"{node_name} GPU {gpu_index}: no free placement for {profile} "
            f"(memory slices taken {sorted(taken)}, compute slices {compute})")

    def create(self, node_name: str, gpu_index: int, profile: str,
               quantity: int) -> List[MigDevice]:
        """``quantity`` instances of ``profile``, each at its first free
        placement; all or none."""
        with self._lock:
            created: List[MigDevice] = []
            try:
                for _ in range(quantity):
                    created.append(self._place(node_name, gpu_index, profile))
            except MigPlacementError:
                for d in created:
                    del self._devices[node_name][d.uuid]
                raise
            return created

    def delete(self, node_name: str, uuid: str) -> None:
        with self._lock:
            node = self._devices.get(node_name, {})
            if uuid not in node:
                raise KeyError(f"MIG device {uuid} not found on {node_name}")
            del node[uuid]

    def geometry(self, node_name: str) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return device_geometry(self._devices.get(node_name, {}).values())


class SimMigClient:
    """MigDeviceClient over one node of a SimMigPool."""

    def __init__(self, pool: SimMigPool, node_name: str) -> None:
        self.pool = pool
        self.node_name = node_name

    def get_mig_devices(self) -> List[MigDevice]:
        return self.pool.get(self.node_name)

    def create_mig_instance(self, gpu_index: int, profile: str) -> MigDevice:
        return self.pool.create(self.node_name, gpu_index, profile, 1)[0]

    def create_mig_devices(self, gpu_index: int, profiles: Dict[str, int]) -> List[MigDevice]:
        return create_in_some_order(self.create_mig_instance, self.delete_mig_device,
                                    gpu_index, profiles)

    def delete_mig_device(self, uuid: str) -> None:
        self.pool.delete(self.node_name, uuid)


class SimPodResourcesClient:
    """Which MIG devices the pods bound to ``node_name`` hold: each
    pending or running pod takes devices of the profiles it asks for,
    the smallest uuid first (the sim stand-in for the kubelet's
    allocation records). ``devices_fn`` lists the node's MIG devices."""

    def __init__(self, store: NodeStore, node_name: str,
                 devices_fn: Callable[[], List[MigDevice]]) -> None:
        self.store = store
        self.node_name = node_name
        self._devices_fn = devices_fn

    def get_used_device_ids(self) -> List[str]:
        demand: Dict[str, int] = {}
        for pod in self.store.list("Pod"):
            if pod.node != self.node_name or pod.phase not in (PodPhase.PENDING,
                                                                PodPhase.RUNNING):
                continue
            for name, qty in pod.request.items():
                if name.startswith(MIG_RESOURCE_PREFIX):
                    profile = name[len(MIG_RESOURCE_PREFIX):]
                    demand[profile] = demand.get(profile, 0) + int(qty)
        used: List[str] = []
        for device in sorted(self._devices_fn(), key=lambda d: d.uuid):
            if demand.get(device.profile, 0) > 0:
                demand[device.profile] -= 1
                used.append(device.uuid)
        return used


class DevicePluginAdvertiser:
    """Re-advertises a node's MIG instances on its allocatable: what a
    restart of the NVIDIA device plugin does (pkg/gpu/client.go:51-135).
    ``geometry_fn(node)`` gives {GPU: {profile: count}}, from the sim's
    pool or from NVML's devices."""

    def __init__(self, store: NodeStore,
                 geometry_fn: Callable[[str], Dict[int, Dict[str, int]]]) -> None:
        self.store = store
        self.geometry_fn = geometry_fn

    def restart(self, node_name: str) -> None:
        if self.store.try_get("Node", node_name) is None:
            return
        geometry = self.geometry_fn(node_name)
        advertised: Dict[str, int] = {}
        for profiles in geometry.values():
            for profile, qty in profiles.items():
                advertised[mig_resource(profile)] = advertised.get(mig_resource(profile), 0) + qty
        carved = sum(1 for profiles in geometry.values() if any(profiles.values()))

        def mutate(node) -> None:
            target = node.allocatable
            for key in [k for k in target if k.startswith(MIG_RESOURCE_PREFIX)]:
                del target[key]
            target.update(advertised)
            # the capacity stays the physical GPUs; a GPU carved into MIG
            # instances is no longer requestable whole
            target[RESOURCE_GPU] = max(0, int(node.capacity.get(RESOURCE_GPU, 0)) - carved)

        self.store.patch_merge("Node", node_name, "", mutate)


class SimDevicePlugin(DevicePluginAdvertiser):
    def __init__(self, store: NodeStore, pool: SimMigPool) -> None:
        super().__init__(store, pool.geometry)
