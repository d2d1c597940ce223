"""Device-layer types (reference pkg/resource/device.go:26-68 and
pkg/gpu/device.go); counterpart of ``nos_tpu/device/types.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable


class DeviceStatus:
    FREE = "free"
    USED = "used"


@dataclass(frozen=True)
class MigDevice:
    """One MIG device: a GPU instance with the compute instance that spans
    it, as NVML and the device plugin name it (``MIG-<uuid>``)."""

    uuid: str
    gpu_index: int
    profile: str        # "3g.40gb"
    start: int          # the placement's first memory slice
    size: int           # memory slices
    status: str = DeviceStatus.FREE


@dataclass(frozen=True)
class SharedSlice:
    """One MPS slice a device plugin advertises: a replica of a GPU
    renamed ``nvidia.com/gpu-<N>gb`` (``device/sharing.py``)."""

    uuid: str
    gpu_index: int
    profile: str        # "20gb"
    status: str = DeviceStatus.FREE


def group_geometries(
    devices: Iterable,
) -> Dict[str, Dict[int, Dict[str, int]]]:
    """Devices (``MigDevice`` or ``SharedSlice``) → {status: {gpu:
    {profile: count}}} for the status annotations (reference
    pkg/gpu/device.go:98-120)."""
    out: Dict[str, Dict[int, Dict[str, int]]] = {
        DeviceStatus.FREE: {},
        DeviceStatus.USED: {},
    }
    for d in devices:
        gpu = out[d.status].setdefault(d.gpu_index, {})
        gpu[d.profile] = gpu.get(d.profile, 0) + 1
    return out


def device_geometry(devices: Iterable) -> Dict[int, Dict[str, int]]:
    """Devices → {gpu: {profile: count}}, free and used together."""
    out: Dict[int, Dict[str, int]] = {}
    for d in devices:
        gpu = out.setdefault(d.gpu_index, {})
        gpu[d.profile] = gpu.get(d.profile, 0) + 1
    return out
