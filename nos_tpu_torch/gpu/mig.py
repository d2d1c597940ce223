"""MigGpu: one GPU and its MIG geometry.

Counterpart of ``nos_tpu/tpu/board.py`` (``TpuBoard``), the reference's
``mig.GPU`` (pkg/gpu/mig/gpu.go:27-259): tracks used and free MIG
instances and searches the allowed geometries for one that serves lacking
profiles without destroying used instances (UpdateGeometryFor,
gpu.go:158-212). Init picks the fewest-slices geometry (gpu.go:118-127):
the whole GPU as one 7g.80gb instance.

``refused`` holds the geometries the GPU's agent acknowledged but could
not create (a used instance holds a placement the geometry needs: counts
alone, which is all the planner sees, do not show it); the search skips
them, so a plan the GPU cannot take is not re-planned forever.
"""
from __future__ import annotations

from typing import FrozenSet, Optional, Set, Tuple

from nos_tpu_torch.gpu.geometry import (
    Geometry,
    geometry_add,
    geometry_fits,
    geometry_subtract,
)
from nos_tpu_torch.gpu.known import KNOWN_GPUS, allowed_geometries, mig_profile


class MigGpu:
    def __init__(
        self,
        index: int,
        product: str,
        used: Optional[Geometry] = None,
        free: Optional[Geometry] = None,
    ) -> None:
        if product not in KNOWN_GPUS:
            raise ValueError(f"unknown GPU product {product!r}")
        self.index = index
        self.product = product
        self.used: Geometry = dict(used or {})
        self.free: Geometry = dict(free or {})
        self.refused: Set[FrozenSet[Tuple[str, int]]] = set()

    # ------------------------------------------------------------ queries

    @property
    def geometry(self) -> Geometry:
        return geometry_add(self.used, self.free)

    def has_free_capacity(self) -> bool:
        """Free instances exist, or memory slices no used instance holds
        could be carved into some (TpuBoard's chips, counted in memory
        slices)."""
        if self.free:
            return True
        used = sum(mig_profile(p).memory_slices * n for p, n in self.used.items())
        return used < KNOWN_GPUS[self.product].memory_slices

    def plan_clone(self) -> "MigGpu":
        """A planning trial mutates only used / free: copying them (the
        constructor does) is a whole clone."""
        clone = MigGpu(self.index, self.product, used=self.used, free=self.free)
        clone.refused = self.refused
        return clone

    # ---------------------------------------------------------- mutation

    def init_geometry(self) -> bool:
        """Apply the fewest-slices allowed geometry to a GPU with none."""
        if self.geometry:
            return False
        geometries = allowed_geometries(self.product)
        if not geometries:
            return False
        self.free = dict(geometries[0])
        return True

    def allocate(self, profile: str, quantity: int = 1) -> bool:
        if self.free.get(profile, 0) < quantity:
            return False
        self.free[profile] -= quantity
        if self.free[profile] == 0:
            del self.free[profile]
        self.used[profile] = self.used.get(profile, 0) + quantity
        return True

    def update_geometry_for(self, lacking: Geometry) -> bool:
        """Re-carve free slices to serve `lacking`, never touching used
        instances.

        Scans allowed geometries, keeps only those that still contain every
        used instance, and picks the one providing the most lacking
        instances (ties → fewest total instances, the list's order).
        Returns True iff the geometry changed. Reference
        pkg/gpu/mig/gpu.go:158-212.

        As in TpuBoard, `lacking` is net of the cluster's free instances,
        so a GPU that already holds free instances of a wanted profile aims
        for free + wanted of it; and the score weighs each instance by its
        memory slices (TpuBoard weighs by chips), so a free 7g.80gb is
        not carved into seven 1g.10gb for more small instances lacking.
        """
        wanted = {p: n for p, n in lacking.items() if n > 0}
        if not wanted:
            return False

        def weight(profile: str) -> int:
            return mig_profile(profile).memory_slices

        def provided(geometry: Geometry) -> int:
            free_after = geometry_subtract(geometry, self.used)
            return sum(
                min(free_after.get(p, 0), self.free.get(p, 0) + n) * weight(p)
                for p, n in wanted.items()
            )

        best: Optional[Geometry] = None
        best_score = sum(self.free.get(p, 0) * weight(p) for p in wanted)
        for candidate in allowed_geometries(self.product):
            if not geometry_fits(candidate, self.used) or (
                    self.refused and frozenset(candidate.items()) in self.refused):
                continue
            score = provided(candidate)
            if score > best_score:
                best, best_score = candidate, score
        if best is None:
            return False
        self.free = geometry_subtract(best, self.used)
        return True
