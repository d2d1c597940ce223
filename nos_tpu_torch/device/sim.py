"""Simulated MIG hardware: counterpart of ``nos_tpu/device/sim.py:23``
(``SimDevicePool``) and ``:61`` (``SimTpuDeviceClient``).

SimMigPool is each node's "silicon": it keeps the MIG devices of every
GPU and places a new GPU instance as NVML does here, at the first free
start the H100 table allows for its profile, within the seven compute
slices and the profile's instance limit, so a create that NVML would
refuse fails here too (``MigPlacementError``) and the search over
creation orders runs on the CPU. SimMigClient is one node's view of the
pool, with NvmlMigClient's interface.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List

from nos_tpu_torch.device.client import MigPlacementError, create_in_some_order
from nos_tpu_torch.device.types import MigDevice
from nos_tpu_torch.gpu.known import H100_80GB, KNOWN_GPUS, mig_profile


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
            out: Dict[int, Dict[str, int]] = {}
            for d in self._devices.get(node_name, {}).values():
                gpu = out.setdefault(d.gpu_index, {})
                gpu[d.profile] = gpu.get(d.profile, 0) + 1
            return out


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
