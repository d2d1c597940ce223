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


def group_geometries(
    devices: Iterable[MigDevice],
) -> Dict[str, Dict[int, Dict[str, int]]]:
    """Devices → {status: {gpu: {profile: count}}} for the status
    annotations (reference pkg/gpu/device.go:98-120)."""
    out: Dict[str, Dict[int, Dict[str, int]]] = {
        DeviceStatus.FREE: {},
        DeviceStatus.USED: {},
    }
    for d in devices:
        gpu = out[d.status].setdefault(d.gpu_index, {})
        gpu[d.profile] = gpu.get(d.profile, 0) + 1
    return out
