"""The H100-80GB's MIG profiles, and the geometries they pack into.

Counterpart of ``nos_tpu/tpu/known.py`` and of ``enumerate_tilings``
(``nos_tpu/tpu/topology.py:97``); the reference's tables
(pkg/gpu/mig/known_configs.go:24-185) cover the A30 and A100 only.

The table is NVIDIA's, from the Multi-Instance GPU User Guide
(https://docs.nvidia.com/datacenter/tesla/mig-user-guide/), "Supported
MIG Profiles", H100-SXM5-80GB: each profile's fraction of the memory
(eighths: memory slices) and of the SMs (sevenths: compute slices), the
largest number of its instances, and the placements a GPU instance may
take (the first memory slice and the size in memory slices, as
``nvidia-smi mig -lgipp`` lists them and
``nvmlDeviceGetGpuInstancePossiblePlacements_v2`` returns them). Each row
also carries the ``NVML_GPU_INSTANCE_PROFILE_*`` constant of ``nvml.h``
that selects it. ``1g.10gb+me`` (the one 1g instance that may hold the
media engines, ``NVML_GPU_INSTANCE_PROFILE_1_SLICE_REV1``) is left out:
it takes the same slices as ``1g.10gb`` and no user of this table asks
for it.

The allowed geometries are not listed by hand: ``enumerate_geometries``
packs placements into the eight memory slices under the seven compute
slices and each profile's instance limit, and keeps every multiset that
no other packing contains (a packing that could still take an instance
is not a geometry of its own). The GPU is named by the GPU feature
discovery label ``nvidia.com/gpu.product``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
H100_80GB = "NVIDIA-H100-80GB-HBM3"


@dataclass(frozen=True)
class MigProfile:
    name: str                  # "3g.40gb"
    memory_slices: int         # eighths of the memory; a placement's size
    compute_slices: int        # sevenths of the SMs
    max_instances: int
    starts: Tuple[int, ...]    # memory slices a placement may start at
    nvml_profile: int          # NVML_GPU_INSTANCE_PROFILE_* (nvml.h)

    @property
    def memory_gb(self) -> int:
        return int(self.name.split(".")[1][:-2])


@dataclass(frozen=True)
class GpuSpec:
    product: str               # value of nvidia.com/gpu.product
    memory_gb: int             # what MPS slices share
    memory_slices: int
    compute_slices: int
    profiles: Tuple[MigProfile, ...]


KNOWN_GPUS: Dict[str, GpuSpec] = {
    H100_80GB: GpuSpec(
        product=H100_80GB,
        memory_gb=80,
        memory_slices=8,
        compute_slices=7,
        profiles=(
            MigProfile("1g.10gb", 1, 1, 7, (0, 1, 2, 3, 4, 5, 6), 0x0),  # _1_SLICE
            MigProfile("1g.20gb", 2, 1, 4, (0, 2, 4, 6), 0x9),  # _1_SLICE_REV2
            MigProfile("2g.20gb", 2, 2, 3, (0, 2, 4), 0x1),  # _2_SLICE
            MigProfile("3g.40gb", 4, 3, 2, (0, 4), 0x2),  # _3_SLICE
            MigProfile("4g.40gb", 4, 4, 1, (0,), 0x3),  # _4_SLICE
            MigProfile("7g.80gb", 8, 7, 1, (0,), 0x4),  # _7_SLICE
        ),
    ),
}

# NVML_COMPUTE_INSTANCE_PROFILE_<n>_SLICE (nvml.h) by compute slices: the
# one compute instance that spans a GPU instance
COMPUTE_INSTANCE_PROFILES = {1: 0x0, 2: 0x1, 3: 0x2, 4: 0x3, 7: 0x4}

MIG_PROFILES: Dict[str, MigProfile] = {
    p.name: p for p in KNOWN_GPUS[H100_80GB].profiles
}

# Optional wholesale override (the reference's KnownMigGeometriesFile)
_geometry_overrides: Dict[str, List[Dict[str, int]]] = {}


def mig_profile(name: str) -> MigProfile:
    try:
        return MIG_PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown MIG profile {name!r}") from None


def set_known_geometries(overrides: Optional[Dict[str, List[Dict[str, int]]]]) -> None:
    """Replace the enumerated allowed-geometry list for given products.

    Reference mig.SetKnownGeometries (pkg/gpu/mig/known_configs.go:144-150).
    Pass None to clear all overrides.
    """
    global _geometry_overrides
    _geometry_overrides = dict(overrides) if overrides else {}


def known_geometry_overrides() -> Dict[str, List[Dict[str, int]]]:
    """The overrides ``set_known_geometries`` installed (a copy): what a
    spawned process replays to derive the same geometries."""
    return {product: [dict(g) for g in geometries]
            for product, geometries in _geometry_overrides.items()}


@lru_cache(maxsize=None)
def enumerate_geometries(product: str) -> Tuple[Dict[str, int], ...]:
    """The maximal multisets of MIG profiles that pack into one GPU.

    A packing places instances at allowed starts on disjoint memory
    slices, takes at most the compute slices the GPU has and at most each
    profile's instance limit. Memory slices are decided in order (each
    either starts an instance or stays empty), so every packing is
    reached. A multiset is kept when no other packing's multiset
    contains it. Ordered fewest slices first (then by name), as
    ``enumerate_tilings`` orders tilings."""
    spec = KNOWN_GPUS[product]
    found = set()

    def solve(slot: int, taken: int, compute: int, counts: Dict[str, int]) -> None:
        if slot == spec.memory_slices:
            found.add(tuple(sorted((p, n) for p, n in counts.items() if n)))
            return
        solve(slot + 1, taken, compute, counts)  # the slot stays empty
        if taken & (1 << slot):
            return
        for p in spec.profiles:
            end = slot + p.memory_slices
            mask = ((1 << p.memory_slices) - 1) << slot
            if (slot not in p.starts or end > spec.memory_slices or taken & mask
                    or compute + p.compute_slices > spec.compute_slices
                    or counts.get(p.name, 0) >= p.max_instances):
                continue
            counts[p.name] = counts.get(p.name, 0) + 1
            solve(slot + 1, taken | mask, compute + p.compute_slices, counts)
            counts[p.name] -= 1

    solve(0, 0, 0, {})

    def within(a, b) -> bool:
        bd = dict(b)
        return a != b and all(bd.get(p, 0) >= n for p, n in a)

    maximal = [dict(g) for g in found if g and not any(within(g, h) for h in found)]
    return tuple(sorted(maximal, key=lambda g: (sum(g.values()), sorted(g.items()))))


def allowed_geometries(product: str) -> List[Dict[str, int]]:
    """All MIG geometries of one GPU of ``product``, fewest slices first.
    Unknown products yield []."""
    if product not in KNOWN_GPUS:
        return []
    if product in _geometry_overrides:
        return [dict(g) for g in _geometry_overrides[product]]
    return [dict(g) for g in enumerate_geometries(product)]


def profile_for_gb(gb: int, product: str) -> Optional[str]:
    """Smallest MIG profile of ``product`` holding at least ``gb`` GB
    (fewest compute slices among equals): the counterpart of
    ``profile_for_chips``."""
    spec = KNOWN_GPUS.get(product)
    if spec is None:
        return None
    for p in sorted(spec.profiles, key=lambda p: (p.memory_gb, p.compute_slices, p.name)):
        if p.memory_gb >= gb:
            return p.name
    return None


def memory_gb_per_gpu(product: str) -> int:
    """The memory MPS slices of one GPU share (the counterpart of
    ``hbm_gb_per_chip``); 0 when unknown."""
    spec = KNOWN_GPUS.get(product)
    return spec.memory_gb if spec is not None else 0
