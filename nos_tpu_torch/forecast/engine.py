"""Forward-simulation forecasts: fork-based what-if trials on a
planning snapshot.

Counterpart of ``nos_tpu/forecast/engine.py:145-541``
(``ForecastEngine``, with ``GangForecast``, ``BackfillVerdict`` and
``ForecastResult``). Against a snapshot, and never changing it (every
trial runs in a copy-on-write fork reverted before it returns), the
engine answers:

- each pending gang's earliest start: it places whole on the current
  geometry (``feasible-now``, next cycle), only after a re-carve
  (``recarve``: the nodes whose geometry the trial changed, one measured
  re-carve latency more), or it waits for memory bound pods hold
  (``blocked``: the blocking set, earliest expected completion first,
  priced only when every blocker carries the
  ``nos.nebuly.com/expected-completion-ts`` hint);
- backfill safety of each (small pending pod, candidate node) pair: the
  placement must not delay the oldest pending gang (its stage worse, its
  re-carve set larger or its ETA later is unsafe);
- the inputs of the defrag advisor (``forecast/advisor.py``).

Sizes are memory slices, the planner's unit (``_pod_slices``: a
3g.40gb counts 4, an MPS slice its GB / 10, a plain GPU 8), where the reference counts chips: under the parity tests'
translation they are the reference's chips. The trials run the port's
planner (``Planner._plan_pass``, with its F3 repair, ROADMAP.md) on the
port's ``ClusterSnapshot`` and ``SliceTracker``. Every order is sorted
and no clock is read: a forecast is a function of (snapshot, pending,
now). The engine owns its planner (never the control loop's), and keeps
its memos across forecasts as ``plan()`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from nos_tpu_torch.gpu.known import KNOWN_GPUS
from nos_tpu_torch.gpu.node import RESOURCE_GPU
from nos_tpu_torch.kube.store import Pod
from nos_tpu_torch.partitioning.core.codec import effective_size
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot
from nos_tpu_torch.partitioning.core.tracker import SliceTracker
from nos_tpu_torch.scheduler.plugins.gang import gang_of
from nos_tpu_torch.util.tracing import TRACER

# the stages, best first; the order is the backfill predicate
STAGE_FEASIBLE_NOW = "feasible-now"
STAGE_RECARVE = "recarve"
STAGE_BLOCKED = "blocked"
_STAGE_RANK = {STAGE_FEASIBLE_NOW: 0, STAGE_RECARVE: 1, STAGE_BLOCKED: 2}

# a workload's hint: the absolute time (seconds) a pod expects to finish
# by (``nos_tpu/forecast/engine.py:52``); a blocked gang's ETA needs it on
# every blocker
EXPECTED_COMPLETION_ANNOTATION = "nos.nebuly.com/expected-completion-ts"

# the blockers a blocked gang lists at most
MAX_BLOCKING = 8
# memory slices of one H100 (a plain nvidia.com/gpu request)
_GPU_SLICES = KNOWN_GPUS["NVIDIA-H100-80GB-HBM3"].memory_slices


def _pod_slices(pod: Pod) -> float:
    """The memory slices a pod asks for."""
    total = 0
    for name, qty in pod.request.items():
        if name == RESOURCE_GPU:
            total += _GPU_SLICES * int(qty)
        else:
            total += effective_size(name) * int(qty)
    return total


@dataclass
class GangForecast:
    """One pending gang's earliest-start classification."""

    gang: str
    size: int
    pending: List[str]  # the still-pending members
    stage: str
    eta_seconds: Optional[float]
    # recarve: the nodes the trial re-carved (for blocked, what the
    # failed trial touched)
    recarve: List[str] = field(default_factory=list)
    # blocked: the bound pods whose memory the gang waits on
    blocking: List[Dict[str, Any]] = field(default_factory=list)
    wait_seconds: Optional[float] = None  # the age of the gang's wait clock

    def payload(self) -> Dict[str, Any]:
        return {"gang": self.gang, "size": self.size, "pending": list(self.pending),
                "stage": self.stage, "eta_seconds": self.eta_seconds,
                "recarve": list(self.recarve), "blocking": [dict(b) for b in self.blocking],
                "wait_seconds": self.wait_seconds}


@dataclass
class BackfillVerdict:
    pod: str
    node: str
    safe: bool
    reason: str

    def payload(self) -> Dict[str, Any]:
        return {"pod": self.pod, "node": self.node, "safe": self.safe, "reason": self.reason}


@dataclass
class ForecastResult:
    now: float
    gangs: List[GangForecast]
    backfill: List[BackfillVerdict]
    heatmap: Dict[str, Dict[str, int]]
    advisor: Optional[Dict[str, Any]] = None

    @property
    def unsafe_count(self) -> int:
        return sum(1 for v in self.backfill if not v.safe)

    def payload(self) -> Dict[str, Any]:
        return {
            "now": self.now,
            "gangs": [g.payload() for g in self.gangs],
            "backfill": {"safe": sum(1 for v in self.backfill if v.safe),
                         "unsafe": self.unsafe_count,
                         "pairs": [v.payload() for v in self.backfill]},
            "heatmap": {k: dict(v) for k, v in sorted(self.heatmap.items())},
            "advisor": self.advisor,
        }


class ForecastEngine:
    """Forecasts over a snapshot and a pending set. ``planner`` is the
    engine's own: sharing the control loop's would clobber its per-plan
    memos mid-cycle."""

    def __init__(self, planner, max_gangs: int = 32, max_backfill_pairs: int = 64,
                 small_pod_chips: float = 2) -> None:
        self.planner = planner
        self.max_gangs = max_gangs
        self.max_backfill_pairs = max_backfill_pairs
        # a "small" pod asks at most this many memory slices (the
        # reference's name, its chips)
        self.small_pod_chips = small_pod_chips

    # ------------------------------------------------------------ entry

    def forecast(self, snapshot: ClusterSnapshot, pending: List[Pod], now: float,
                 clocks: Optional[Dict[str, Dict[str, float]]] = None,
                 cycle_seconds: float = 1.0, reconfig_seconds: float = 0.5,
                 with_backfill: bool = True) -> ForecastResult:
        """Classify each pending gang and, with ``with_backfill``, each
        small-pod backfill pair; the snapshot comes back as it was."""
        planner = self.planner
        if snapshot is planner._cache_snapshot:
            planner._prune_plan_caches(snapshot, pending)
        else:
            planner._reset_plan_caches(snapshot)
        clocks = clocks or {}
        # warm the free pool before any fork checkpoints it
        snapshot.free_slice_resources()
        gangs = self._gang_groups(pending)
        results: List[GangForecast] = []
        with TRACER.span("forecast.gangs", gangs=len(gangs)):
            for key, (size, members) in gangs[:self.max_gangs]:
                results.append(self._classify_gang(snapshot, key, size, members, now, clocks,
                                                   cycle_seconds, reconfig_seconds))
        backfill: List[BackfillVerdict] = []
        heatmap: Dict[str, Dict[str, int]] = {}
        if with_backfill and results:
            with TRACER.span("forecast.backfill"):
                backfill, heatmap = self._backfill_safety(
                    snapshot, pending, gangs, results, now, clocks, cycle_seconds,
                    reconfig_seconds)
        return ForecastResult(now=now, gangs=results, backfill=backfill, heatmap=heatmap)

    # ------------------------------------------------------ gang grouping

    @staticmethod
    def _gang_groups(pending: List[Pod]) -> List[Tuple[str, Tuple[int, List[Pod]]]]:
        """(gang key, (declared size, pending members)) by key; members
        largest first, then by name."""
        groups: Dict[str, Tuple[int, List[Pod]]] = {}
        for pod in pending:
            gang = gang_of(pod)
            if not gang:
                continue
            key, size = gang
            groups.setdefault(key, (size, []))[1].append(pod)
        out = []
        for key in sorted(groups):
            size, members = groups[key]
            members.sort(key=lambda p: (-_pod_slices(p), p.namespaced_name))
            out.append((key, (size, members)))
        return out

    # ------------------------------------------------- stage classification

    def _classify_gang(self, snapshot: ClusterSnapshot, key: str, size: int,
                       members: List[Pod], now: float, clocks: Dict[str, Dict[str, float]],
                       cycle_seconds: float, reconfig_seconds: float) -> GangForecast:
        clock = clocks.get(key)
        wait = max(0.0, now - clock["arrival"]) if clock else None
        names = [p.namespaced_name for p in members]
        feasible, _ = self._claim_trial(snapshot, members)
        if feasible:
            # the next plan / bind cycle
            return GangForecast(gang=key, size=size, pending=names, stage=STAGE_FEASIBLE_NOW,
                                eta_seconds=cycle_seconds, wait_seconds=wait)
        placed_all, recarve = self._carve_trial(snapshot, members)
        if placed_all:
            # the agents re-carve a plan's nodes at once: one latency
            eta = cycle_seconds + (reconfig_seconds if recarve else 0.0)
            return GangForecast(gang=key, size=size, pending=names, stage=STAGE_RECARVE,
                                eta_seconds=eta, recarve=recarve, wait_seconds=wait)
        blocking, eta = self._blocking_set(snapshot, members, now, cycle_seconds)
        return GangForecast(gang=key, size=size, pending=names, stage=STAGE_BLOCKED,
                            eta_seconds=eta, recarve=recarve, blocking=blocking,
                            wait_seconds=wait)

    def _claim_trial(self, snapshot: ClusterSnapshot,
                     members: List[Pod]) -> Tuple[bool, List[str]]:
        """Whether every member places on the current geometry; (all
        placed, the nodes used)."""
        planner = self.planner
        snapshot.fork()
        try:
            used: List[str] = []
            for pod in members:
                claims = planner._claims_free_slices(pod)
                placed_on = None
                for node_name in planner._candidate_nodes(snapshot):
                    if claims and not snapshot.node_has_free_slices(node_name):
                        continue
                    if planner._try_add_pod(snapshot, node_name, pod):
                        placed_on = node_name
                        break
                if placed_on is None:
                    return False, used
                used.append(placed_on)
            return True, used
        finally:
            snapshot.revert()

    def _carve_trial(self, snapshot: ClusterSnapshot,
                     members: List[Pod]) -> Tuple[bool, List[str]]:
        """Whether the gang places after re-carving; (all placed, the nodes
        whose geometry the trial changed)."""
        planner = self.planner
        snapshot.fork()
        try:
            tracker = SliceTracker(snapshot, members)
            placed = planner._plan_pass(snapshot, tracker, members, set())
            placed_names = {p.namespaced_name for p in placed}
            all_placed = all(p.namespaced_name in placed_names for p in members)
            # the trial's commits folded into this fork's journal: each
            # touched node's pre-fork clone is there
            journal = snapshot._journals[-1]
            nodes = snapshot.get_nodes()
            recarve = [name for name in sorted(journal)
                       if name in nodes and nodes[name].partitionable.geometry()
                       != journal[name].partitionable.geometry()]
            return all_placed, recarve
        finally:
            snapshot.revert()

    def _blocking_set(self, snapshot: ClusterSnapshot, members: List[Pod], now: float,
                      cycle_seconds: float) -> Tuple[List[Dict[str, Any]], Optional[float]]:
        """The bound pods the gang waits on, earliest expected completion
        first (hintless ones last); the ETA only when every chosen blocker
        is hinted and they cover the gang."""
        needed = sum(_pod_slices(p) for p in members)
        nodes = snapshot.get_nodes()
        candidates: List[Any] = []
        for name in sorted(nodes):
            for pod in nodes[name].pods:
                slices = _pod_slices(pod)
                if slices <= 0:
                    continue
                hint = pod.annotations.get(EXPECTED_COMPLETION_ANNOTATION)
                completion: Optional[float] = None
                if hint is not None:
                    try:
                        completion = float(hint)
                    except ValueError:
                        completion = None
                candidates.append((completion, name, pod, slices))
        candidates.sort(key=lambda c: (c[0] is None, c[0] if c[0] is not None else 0.0,
                                       c[2].namespaced_name))
        blocking: List[Dict[str, Any]] = []
        covered = 0.0
        latest_completion: Optional[float] = 0.0
        for completion, name, pod, slices in candidates:
            if covered >= needed or len(blocking) >= MAX_BLOCKING:
                break
            entry = {"pod": pod.namespaced_name, "node": name, "chips": slices,
                     "explain": f"/debug/explain?pod={pod.namespaced_name}"}
            if completion is not None:
                entry["expected_completion_ts"] = completion
                if latest_completion is not None:
                    latest_completion = max(latest_completion, completion)
            else:
                latest_completion = None
            blocking.append(entry)
            covered += slices
        eta: Optional[float] = None
        if blocking and latest_completion is not None and covered >= needed:
            # the memory frees when the slowest blocker ends; the next cycle
            # binds the gang
            eta = max(0.0, latest_completion - now) + cycle_seconds
        return blocking, eta

    # -------------------------------------------------- backfill predicate

    def _backfill_safety(self, snapshot: ClusterSnapshot, pending: List[Pod], gangs,
                         gang_results: List[GangForecast], now: float,
                         clocks: Dict[str, Dict[str, float]], cycle_seconds: float,
                         reconfig_seconds: float
                         ) -> Tuple[List[BackfillVerdict], Dict[str, Dict[str, int]]]:
        """Place each small pod on each candidate node in a fork and
        re-classify the oldest pending gang: unsafe when it gets worse."""
        oldest = self._oldest_gang(gangs, gang_results)
        if oldest is None:
            return [], {}
        oldest_key, oldest_size, oldest_members, baseline = oldest
        planner = self.planner
        small = sorted((p for p in pending
                        if not gang_of(p) and 0 < _pod_slices(p) <= self.small_pod_chips),
                       key=lambda p: p.namespaced_name)
        verdicts: List[BackfillVerdict] = []
        heatmap: Dict[str, Dict[str, int]] = {}
        for pod in small:
            if len(verdicts) >= self.max_backfill_pairs:
                break
            claims = planner._claims_free_slices(pod)
            for node_name in planner._candidate_nodes(snapshot):
                if len(verdicts) >= self.max_backfill_pairs:
                    break
                if claims and not snapshot.node_has_free_slices(node_name):
                    continue
                snapshot.fork()
                try:
                    if not planner._try_add_pod(snapshot, node_name, pod):
                        continue  # no slice here for this pod
                    after = self._classify_gang(snapshot, oldest_key, oldest_size,
                                                oldest_members, now, clocks, cycle_seconds,
                                                reconfig_seconds)
                finally:
                    snapshot.revert()
                safe, reason = self._compare(baseline, after)
                verdicts.append(BackfillVerdict(pod=pod.namespaced_name, node=node_name,
                                                safe=safe, reason=reason))
                cell = heatmap.setdefault(node_name, {"safe": 0, "unsafe": 0})
                cell["safe" if safe else "unsafe"] += 1
        return verdicts, heatmap

    @staticmethod
    def _oldest_gang(gangs, gang_results):
        """(key, size, members, baseline) of the gang backfill protects:
        the longest wait, then the key."""
        if not gang_results:
            return None
        by_key = {key: entry for key, entry in gangs}
        best = min(gang_results, key=lambda g: (-(g.wait_seconds or 0.0), g.gang))
        size, members = by_key[best.gang]
        return best.gang, size, members, best

    @staticmethod
    def _compare(before: GangForecast, after: GangForecast) -> Tuple[bool, str]:
        if _STAGE_RANK[after.stage] > _STAGE_RANK[before.stage]:
            return False, f"oldest gang {before.gang} degrades {before.stage} -> {after.stage}"
        if (after.stage == STAGE_RECARVE and before.stage == STAGE_RECARVE
                and len(after.recarve) > len(before.recarve)):
            return False, (f"oldest gang {before.gang} re-carve set grows "
                           f"{len(before.recarve)} -> {len(after.recarve)}")
        if (before.eta_seconds is not None and after.eta_seconds is not None
                and after.eta_seconds > before.eta_seconds):
            return False, (f"oldest gang {before.gang} ETA grows "
                           f"{before.eta_seconds:.3f}s -> {after.eta_seconds:.3f}s")
        return True, ""
