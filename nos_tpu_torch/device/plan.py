"""Declarative MIG plan diff (reference
internal/controllers/migagent/plan/plan.go:31-92); counterpart of
``nos_tpu/controllers/tpuagent/plan.py:35``.

Given the devices that exist and the spec geometries the control plane
wants, produce delete and create operations. Deletes run before creates
(actuator.go:152-200). Used devices are never deleted: the planner never
plans away used instances (MigGpu.update_geometry_for keeps them), so a
diff that would need it means stale state, and the loop retries after
the next report.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from nos_tpu_torch.device.types import DeviceStatus, MigDevice


@dataclass
class CreateOp:
    gpu_index: int
    profile: str
    quantity: int


@dataclass
class MigPlan:
    deletes: List[MigDevice] = field(default_factory=list)
    creates: List[CreateOp] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.deletes and not self.creates


def compute_plan(devices: List[MigDevice], spec: Dict[int, Dict[str, int]]) -> MigPlan:
    existing: Dict[Tuple[int, str], List[MigDevice]] = {}
    for d in devices:
        existing.setdefault((d.gpu_index, d.profile), []).append(d)

    plan = MigPlan()
    # deletes: free devices beyond the spec's count (or of profiles it lacks)
    for (gpu, profile), devs in sorted(existing.items()):
        excess = len(devs) - spec.get(gpu, {}).get(profile, 0)
        if excess <= 0:
            continue
        free = sorted((d for d in devs if d.status == DeviceStatus.FREE),
                      key=lambda d: d.uuid)
        plan.deletes.extend(free[:excess])

    # creates: the spec's count beyond what exists
    for gpu in sorted(spec):
        for profile in sorted(spec[gpu]):
            want = spec[gpu][profile]
            have = len(existing.get((gpu, profile), []))
            if want > have:
                plan.creates.append(CreateOp(gpu, profile, want - have))
    return plan
