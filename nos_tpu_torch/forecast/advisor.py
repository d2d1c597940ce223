"""Read-only defrag advisor: re-carve recommendations, never actuation.

Counterpart of ``nos_tpu/forecast/advisor.py:34-210`` (``DefragAdvisor``)
over the port's ``ClusterSnapshot`` and ``SliceTracker``. Nodes mostly
free (free memory slices over the node's, at or above
``free_fraction``) but carved for a mix the pending queue no longer
wants are proposed for a re-carve toward the queue's lacking profiles;
each proposal is applied in a fork, every pending gang is forecast again
against it, and the predicted saving is each gang's ETA gain times its
pending memory slices (the reference's chip-seconds, in memory-slice
seconds). ``validated`` holds only when some gang starts earlier and
none gets worse. Nothing here writes to the store.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from nos_tpu_torch.forecast.engine import (
    _STAGE_RANK,
    ForecastEngine,
    GangForecast,
    _pod_slices,
)
from nos_tpu_torch.gpu.known import KNOWN_GPUS
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot
from nos_tpu_torch.partitioning.core.tracker import SliceTracker
from nos_tpu_torch.util.tracing import TRACER


def _node_slices(partitionable) -> int:
    """A node's memory slices: its GPUs x its product's (8 an H100)."""
    spec = KNOWN_GPUS.get(getattr(partitionable, "product", ""))
    per_gpu = spec.memory_slices if spec is not None else 8
    return len(partitionable.gpus) * per_gpu


class DefragAdvisor:
    def __init__(self, engine: ForecastEngine, free_fraction: float = 0.5,
                 max_proposals: int = 4) -> None:
        self.engine = engine
        self.free_fraction = free_fraction
        self.max_proposals = max_proposals

    def advise(self, snapshot: ClusterSnapshot, pending, before: List[GangForecast],
               now: float, clocks: Optional[Dict[str, Dict[str, float]]] = None,
               cycle_seconds: float = 1.0, reconfig_seconds: float = 0.5) -> Dict[str, Any]:
        """The advice of one forecast cycle; ``before`` is the cycle's own
        gang forecasts, so the shadow compares against what was
        published."""
        with TRACER.span("forecast.advisor"):
            return self._advise(snapshot, pending, before, now, clocks or {}, cycle_seconds,
                                reconfig_seconds)

    def _advise(self, snapshot: ClusterSnapshot, pending, before: List[GangForecast],
                now: float, clocks: Dict[str, Dict[str, float]], cycle_seconds: float,
                reconfig_seconds: float) -> Dict[str, Any]:
        tracker = SliceTracker(snapshot, list(pending))
        candidates = self._near_empty_nodes(snapshot)
        out: Dict[str, Any] = {
            "proposals": [],
            "predicted_idle_savings_chip_seconds": 0.0,
            "validated": False,
            "near_empty_nodes": [name for name, _ in candidates],
        }
        if tracker.empty or not candidates or not before:
            return out
        snapshot.free_slice_resources()  # warm the pool before the fork
        snapshot.fork()
        try:
            proposals: List[Dict[str, Any]] = []
            nodes = snapshot.get_nodes()
            for name, _free in candidates:
                if len(proposals) >= self.max_proposals:
                    break
                lacking = tracker.lacking_totals()
                if not lacking:
                    continue
                geometry_before = {gpu: dict(g) for gpu, g
                                   in nodes[name].partitionable.geometry().items()}
                if not snapshot.update_geometry_for(name, lacking):
                    continue
                geometry_after = {gpu: dict(g) for gpu, g
                                  in nodes[name].partitionable.geometry().items()}
                proposals.append({"node": name, "geometry_before": geometry_before,
                                  "geometry_after": geometry_after,
                                  "toward": dict(sorted(lacking.items()))})
            if not proposals:
                return out
            after = self.engine.forecast(snapshot, list(pending), now, clocks=clocks,
                                         cycle_seconds=cycle_seconds,
                                         reconfig_seconds=reconfig_seconds,
                                         with_backfill=False).gangs
        finally:
            snapshot.revert()
        after_by_key = {g.gang: g for g in after}
        savings = 0.0
        regressed = False
        per_gang: List[Dict[str, Any]] = []
        for base in before:
            shadow = after_by_key.get(base.gang)
            if shadow is None:
                continue
            if _STAGE_RANK[shadow.stage] > _STAGE_RANK[base.stage]:
                regressed = True
            gang_slices = self._gang_pending_slices(pending, base)
            saved = 0.0
            if base.eta_seconds is not None and shadow.eta_seconds is not None:
                saved = max(0.0, base.eta_seconds - shadow.eta_seconds)
            elif base.eta_seconds is None and shadow.eta_seconds is not None:
                # from no ETA (blocked, unhinted) to one: the wait so far
                saved = max(base.wait_seconds or 0.0, cycle_seconds)
            savings += saved * gang_slices
            per_gang.append({"gang": base.gang, "stage_before": base.stage,
                             "stage_after": shadow.stage, "eta_before": base.eta_seconds,
                             "eta_after": shadow.eta_seconds,
                             "saved_chip_seconds": saved * gang_slices})
        out["proposals"] = proposals
        out["predicted_idle_savings_chip_seconds"] = savings
        out["validated"] = bool(proposals) and savings > 0.0 and not regressed
        out["gangs"] = per_gang
        return out

    def _near_empty_nodes(self, snapshot: ClusterSnapshot):
        """(name, free memory slices) of the nodes not mid re-carve whose
        free share is at or above the threshold, most free first. Free is
        the node's slices less its pods', not its carved free slices: an
        uncarved node, the best candidate, has none carved."""
        out = []
        nodes = snapshot.get_nodes()
        for name in sorted(nodes):
            node = nodes[name]
            if node.frozen:
                continue
            total = _node_slices(node.partitionable)
            free = total - sum(_pod_slices(p) for p in node.pods)
            if total <= 0 or free <= 0:
                continue
            if free / total >= self.free_fraction:
                out.append((name, free))
        out.sort(key=lambda item: (-item[1], item[0]))
        return out

    @staticmethod
    def _gang_pending_slices(pending, forecast: GangForecast):
        names = set(forecast.pending)
        return sum(_pod_slices(p) for p in pending if p.namespaced_name in names)
