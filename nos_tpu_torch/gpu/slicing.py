"""SharedGpu: one GPU's memory carved into MPS slices.

Counterpart of ``nos_tpu/tpu/sharing.py:28`` (``SharedChip``), the
reference's MPS slicing domain (pkg/gpu/slicing/gpu.go:27-265): several
processes share the GPU's SMs through MPS, each holding an
``nvidia.com/gpu-<N>gb`` slice of its memory (the client's
``CUDA_MPS_PINNED_DEVICE_MEM_LIMIT``). Geometry search is a memory-budget
bin problem: first create missing slices from spare memory, then sacrifice
free slices to make room (reference slicing/gpu.go:162-220), never
touching used slices.
"""
from __future__ import annotations

from typing import Dict, Optional

from nos_tpu_torch.gpu.geometry import Geometry, geometry_add

MIN_SLICE_GB = 1  # reference pkg/gpu/slicing/constant.go:23


def profile_gb(profile: str) -> int:
    """'20gb' -> 20; raises ValueError for anything else."""
    if not profile.endswith("gb") or not profile[:-2].isdigit():
        raise ValueError(f"{profile!r} is not an MPS slice profile")
    return int(profile[:-2])


class SharedGpu:
    """One GPU with a memory budget carved into MPS slices.

    Mirrors reference slicing.GPU: `used`/`free` map profile ("20gb") to
    slice count; the invariant is Σ(profile_gb · count) ≤ memory_gb.
    """

    def __init__(
        self,
        index: int,
        memory_gb: int,
        used: Optional[Geometry] = None,
        free: Optional[Geometry] = None,
    ) -> None:
        self.index = index
        self.memory_gb = memory_gb
        self.used: Geometry = dict(used or {})
        self.free: Geometry = dict(free or {})

    # ----------------------------------------------------------- queries

    @property
    def geometry(self) -> Geometry:
        return geometry_add(self.used, self.free)

    def committed_memory_gb(self) -> int:
        """Memory held by existing slices, used or free."""
        return sum(profile_gb(p) * q for p, q in self.geometry.items())

    def spare_memory_gb(self) -> int:
        return self.memory_gb - self.committed_memory_gb()

    def has_free_capacity(self) -> bool:
        return bool(self.free) or self.spare_memory_gb() >= MIN_SLICE_GB

    def plan_clone(self) -> "SharedGpu":
        """used / free are the only state a planning trial mutates."""
        return SharedGpu(self.index, self.memory_gb, used=self.used, free=self.free)

    # ---------------------------------------------------------- mutation

    def _create(self, profile: str, quantity: int = 1) -> int:
        """Create up to `quantity` free slices of `profile` from spare
        memory; returns how many were created."""
        gb = profile_gb(profile)
        created = 0
        for _ in range(quantity):
            if gb < MIN_SLICE_GB or gb > self.spare_memory_gb():
                break
            self.free[profile] = self.free.get(profile, 0) + 1
            created += 1
        return created

    def allocate(self, profile: str) -> bool:
        """Move one free slice to used (a process binding to it)."""
        if self.free.get(profile, 0) <= 0:
            return False
        self.free[profile] -= 1
        if self.free[profile] == 0:
            del self.free[profile]
        self.used[profile] = self.used.get(profile, 0) + 1
        return True

    def update_geometry_for(self, required: Geometry) -> bool:
        """Re-carve the GPU toward `required` (profile → wanted count)
        without destroying used slices: smaller profiles first, spare
        memory first, then trade free slices away, restoring what still
        fits (reference slicing/gpu.go:162-220). As in SharedChip, the
        trade never sacrifices free slices a required profile still
        needs. Returns True when the geometry changed."""
        missing: Dict[str, int] = {}
        for profile, qty in required.items():
            diff = qty - self.free.get(profile, 0)
            if diff > 0:
                missing[profile] = diff
        if not missing:
            return False

        updated = False
        for profile in sorted(missing, key=profile_gb):
            created = self._create(profile, missing[profile])
            missing[profile] -= created
            if created:
                updated = True
            if missing[profile] <= 0:
                continue
            if self._trade_for(profile, missing[profile], required):
                updated = True
        return updated

    def _trade_for(self, profile: str, quantity: int, required: Geometry) -> bool:
        """Sacrifice expendable free slices (profiles nobody requires, or
        counts beyond a profile's required quota) to make room for
        `quantity` slices of `profile`; whatever was sacrificed but not
        consumed is restored afterwards."""
        gb = profile_gb(profile)
        sacrificed: Dict[str, int] = {}
        created_any = False
        for _ in range(quantity):
            while self.spare_memory_gb() < gb:
                victim = self._pick_expendable(required)
                if victim is None:
                    break
                self.free[victim] -= 1
                if self.free[victim] == 0:
                    del self.free[victim]
                sacrificed[victim] = sacrificed.get(victim, 0) + 1
            if self._create(profile) != 1:
                break
            created_any = True
        # put back sacrificed slices that still fit, largest first
        for victim in sorted(sacrificed, key=profile_gb, reverse=True):
            self._create(victim, sacrificed[victim])
        return created_any

    def _pick_expendable(self, required: Geometry) -> Optional[str]:
        """A free slice safe to destroy: smallest non-required profile
        first, then the smallest required profile with free count above
        its requirement."""
        candidates = [p for p in self.free if p not in required]
        if not candidates:
            candidates = [p for p in self.free if self.free[p] > required.get(p, 0)]
        if not candidates:
            return None
        return min(candidates, key=profile_gb)
