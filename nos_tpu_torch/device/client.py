"""GpuClient: the composed device view (reference pkg/gpu/mig/client.go,
which composes nvml.Client and resource.Client); counterpart of
``nos_tpu/device/client.py``.

``MigDeviceClient`` is the nvml.Client-shaped seam
(pkg/gpu/nvml/interface.go:23-36): ``nvml.NvmlMigClient`` on a GPU,
``sim.SimMigClient`` anywhere else. Both place a GPU instance at the first
free placement its profile allows, so a batch's outcome depends on the
order of its creates; ``create_in_some_order`` is the reference's search
over creation orders (pkg/gpu/nvml/client.go:286-340).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, List, Protocol, Sequence

from nos_tpu_torch.device.types import DeviceStatus, MigDevice

MAX_CREATION_ORDERS = 20  # reference pkg/gpu/nvml/client.go:290-294


class MigPlacementError(RuntimeError):
    """No free placement on the GPU takes the profile."""


class MigDeviceClient(Protocol):
    def get_mig_devices(self) -> List[MigDevice]: ...

    def create_mig_instance(self, gpu_index: int, profile: str) -> MigDevice: ...

    def create_mig_devices(self, gpu_index: int, profiles: Dict[str, int]) -> List[MigDevice]: ...

    def delete_mig_device(self, uuid: str) -> None: ...


class PodResourcesClient(Protocol):
    """Which device ids pods hold: the kubelet pod-resources counterpart
    (pkg/resource/client.go:27-30)."""

    def get_used_device_ids(self) -> List[str]: ...


def creation_orders(profiles: Sequence[str]) -> Iterator[List[str]]:
    """The distinct orders of ``profiles`` in lexicographic order, the
    sorted one first."""
    order = sorted(profiles)
    while True:
        yield list(order)
        i = len(order) - 2
        while i >= 0 and order[i] >= order[i + 1]:
            i -= 1
        if i < 0:
            return
        j = len(order) - 1
        while order[j] <= order[i]:
            j -= 1
        order[i], order[j] = order[j], order[i]
        order[i + 1:] = reversed(order[i + 1:])


def create_in_some_order(
    create: Callable[[int, str], MigDevice],
    delete: Callable[[str], None],
    gpu_index: int,
    profiles: Dict[str, int],
) -> List[MigDevice]:
    """Create ``profiles`` (profile → count) on one GPU, all or none.

    Each order of the creates is tried in turn, at most
    MAX_CREATION_ORDERS; an order that meets a profile with no free
    placement deletes what it created and gives way to the next. Any
    other error is raised at once."""
    wanted = [p for p, n in sorted(profiles.items()) for _ in range(n)]
    if not wanted:
        return []
    refused, tried = None, 0
    for order in itertools.islice(creation_orders(wanted), MAX_CREATION_ORDERS):
        tried += 1
        created: List[MigDevice] = []
        try:
            for profile in order:
                created.append(create(gpu_index, profile))
            return created
        except MigPlacementError as e:
            refused = e
            for device in reversed(created):
                delete(device.uuid)
    raise MigPlacementError(
        f"GPU {gpu_index}: no creation order of {profiles} fits (tried {tried}): {refused}")


class GpuClient:
    def __init__(self, device_client: MigDeviceClient,
                 pod_resources: PodResourcesClient) -> None:
        self.device_client = device_client
        self.pod_resources = pod_resources

    def get_devices(self) -> List[MigDevice]:
        """MIG devices with their free / used status resolved."""
        used = set(self.pod_resources.get_used_device_ids())
        return [
            MigDevice(d.uuid, d.gpu_index, d.profile, d.start, d.size,
                      DeviceStatus.USED if d.uuid in used else DeviceStatus.FREE)
            for d in self.device_client.get_mig_devices()
        ]

    def create_devices(self, gpu_index: int, profiles: Dict[str, int]) -> List[MigDevice]:
        """One GPU's creates as a unit (the batch create)."""
        return self.device_client.create_mig_devices(gpu_index, profiles)

    def delete_device(self, uuid: str) -> None:
        self.device_client.delete_mig_device(uuid)
