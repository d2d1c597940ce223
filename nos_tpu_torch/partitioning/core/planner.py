"""Planner: simulate before actuating.

Counterpart of ``nos_tpu/partitioning/core/planner.py`` (reference
internal/partitioning/core/planner.go:67-153): ``sort_candidate_pods``
(``:104``) and ``Planner`` (``:169``) with ``plan`` (``:342``), ``_plan``
(``:504``), ``_plan_pass`` (``:658``), ``_try_add_pod`` and its lacking
shortcut (``:942``), ``_can_schedule`` through the verdict cache
(``:952``), ``_run_simulation`` (``:1006``), ``_simulation_pod``
(``:1052``), the gang pre-pass (``:565-640``, ``_gang_membership`` and
``_half_formable_gangs`` at ``:853-890``) and ``last_unserved``.

A pass has three parts, as in the reference's cold plan. An *aged
rescue*: a pending pod the fairness aging has promoted gets a carve
aimed at exactly its profile before anyone claims free slices (one
rescue a plan, at most three tries). A *claim pre-pass*: pods the
existing free slices already serve are placed first, so no carve can
destroy a slice a pending pod is entitled to; it skips the pod the
rescue placed (the reference places it a second time: ROADMAP.md,
fault F1). Every pod the pre-pass could not place goes back into the
tracker with its whole request lacking (ROADMAP.md, fault F3: free
slices split over nodes cover a multi-slice pod that no node can take,
and the reference never carves for it; nor does it run a pass when the
pool covers every pod, which the port does when a pod's slices lie on
several nodes, ``SliceTracker.split``). Then the *carve loop*: for
each candidate node (best fit first), fork the snapshot, re-carve the
node toward what the pending pods still lack, simulation-schedule each
of them on it with the real scheduler framework (PreFilter + Filter),
and commit the fork when a pod landed, else revert. The lacking
shortcut skips the framework while the cluster cannot serve the pod at
all. Every exit leaves ``last_unserved``: each pending pod asking for
slices that the plan leaves unplaced, with its reason. A pod the
tracker still holds lacks its slices; one the tracker never held (it
asks for another mode's slices) fits no node that holds them. The
reference gives a pod F1's carve left unplaced no reason.

The gang pre-pass: when a gang member is pending, a trial pass runs on
a fork; a gang whose bound members (counted before the fork) and trial
placements fall short of its size is excluded ("gang … cannot fully
form; no slices are carved for partial gangs") and the real pass runs
without it; when no gang is excluded the trial is committed as the
plan.

The simulation goes through the verdict cache (``verdict_cache.py``),
with the same exactness as the reference's; a pod with spread or
affinity terms, or any trial once a placed pod has anti-affinity,
bypasses it and publishes the snapshot's whole view. The lacking
shortcut is memoized on (request, ``state_version``) and the simulated
node views on (node, version). The carve-futility memo (``:176-260``,
``:484-491``) keys a carve that changed no geometry by (node, version,
lacking profile) and skips the fork and carve when the same key comes
again: a failed carve stamps no version and a revert restores the
versions, so a hit replays a no-op exactly (``futility_memo_enabled``
off runs every trial; the tests hold that it changes no plan). A pod's
first sighting is keyed by its namespaced name and uid, so a pod
recreated under its name starts at age 0.

Plan modes (``:280-340``): ``plan(snapshot, pods)`` is ``full``: the
memos are rebuilt and the snapshot is left carrying the plan's carves.
``plan(..., dirty=names)`` preserves its base: the caller keeps one
snapshot across plans and changes it only through ``refresh_node``
(``dirty`` names the nodes it refreshed); the plan runs inside an outer
fork that is reverted before it returns. When the snapshot is the one
the last plan saw and the dirty share is at most
``incremental_dirty_threshold`` of its nodes, the plan is
``incremental``: every memo entry whose version key still matches a
live node survives (``_prune_plan_caches``), so untouched nodes keep
their verdicts, views, candidate order and futility proofs; else it is
``fallback`` (a new snapshot object, or too many dirty nodes): the
memos are rebuilt, the base still preserved. ``last_plan_mode`` names
the mode, ``PLAN_MODE`` counts them and ``PLAN_CARVE_FUTILITY`` the
memo's hits.

The hand-offs (``:401-470``): ``adopt_pending_seen`` carries another
planner's first sightings into this one (a pool planner rebuilt when the
pools change keeps every pod's age); ``export_warm_state`` gives, per
node, the futility proofs and verdicts keyed at the node's current
(observed) version, with their version half dropped, and
``adopt_warm_state`` re-keys such entries at a snapshot's live versions
(``snapcodec.py`` proves first, by each node's state signature, that the
state is the one they were derived from). The keys are the port's own:
a futility entry is (lacking profile items, reason), a verdict (pod
signature, verdict).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from nos_tpu_torch.kube.store import Pod
from nos_tpu_torch.partitioning.core.codec import effective_size, is_slice_resource
from nos_tpu_torch.partitioning.core.partition_state import PartitioningState
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.partitioning.core.tracker import SliceTracker
from nos_tpu_torch.partitioning.core.verdict_cache import (
    VerdictCache,
    needs_cluster_context,
    pod_signature,
)
from nos_tpu_torch.scheduler.framework import (
    TOPOLOGY_NODE_INFOS_KEY,
    CycleState,
    Framework,
    NodeInfo,
    is_verdict_cacheable,
)
from nos_tpu_torch.scheduler.plugins.gang import gang_of
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import resources as res
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.partitioning")

# effective size of boost at which an aged pod gets the dedicated rescue
AGED_RESCUE_SIZE = 2.5
PENDING_TTL_S = 600.0
AGING_PER_SECOND = 1.0  # effective size a second passed over
INCREMENTAL_DIRTY_THRESHOLD = 0.25


def sort_candidate_pods(pods: Iterable[Pod], aging_per_second: float = AGING_PER_SECOND,
                        pending_since: Optional[Dict[str, float]] = None,
                        now: Optional[float] = None) -> List[Pod]:
    """Priority first, then the LARGEST effective slice, then age, then
    namespace / name.

    Largest first, as in the reference (the Go reference sorts smallest
    first, core/util.go:34-71): whole-GPU requests place while whole GPUs
    are still free, small slices fill the rest. Time a pod has been passed
    over (``pending_since``: the instant the planner first saw it, on the
    clock ``now`` is read from, ``time.monotonic`` by default) ages its
    effective size up at ``aging_per_second``, so a small pod left behind
    round after round sorts with, then ahead of, the large arrivals; a
    first sighting is age 0, and aging never crosses a priority. The
    effective size is computed once per pod (decorate-sort-undecorate)."""
    now = time.monotonic() if now is None else now
    pending_since = pending_since or {}
    keyed: List[Tuple[tuple, Pod]] = []
    for pod in pods:
        sizes = [effective_size(name) for name in res.compute_pod_request(pod)]
        age = max(0.0, now - pending_since.get(pod.namespaced_name, now))
        effective = max(sizes, default=0) + age * aging_per_second
        keyed.append(((-pod.priority, -effective, pod.namespace, pod.name), pod))
    keyed.sort(key=lambda kv: kv[0])
    return [pod for _, pod in keyed]


def _relist(value):
    """A memo key's tuples as JSON lists."""
    return [_relist(v) for v in value] if isinstance(value, tuple) else value


def _retuple(value):
    """``_relist``'s inverse: every list a tuple again."""
    return tuple(_retuple(v) for v in value) if isinstance(value, list) else value


def _profile(slices: dict) -> str:
    return ", ".join(f"{int(qty)}x {name}" for name, qty in sorted(slices.items()))


def lacking_reason(lacking: dict) -> str:
    """A lacking profile, read by people: the unserved reason."""
    return f"no node can be re-carved to yield lacking slices ({_profile(lacking)})"


def gang_excluded_reason(gang_key: str) -> str:
    return f"gang {gang_key} cannot fully form; no slices are carved for partial gangs"


def unplaced_reason(request: dict) -> str:
    """The reason of a pod the free slices cover but no node can take."""
    slices = {k: v for k, v in request.items() if is_slice_resource(k) and v}
    return f"the free slices cover it, but no node it fits holds them ({_profile(slices)})"


class Planner:
    def __init__(self, framework: Framework, verdict_cache_enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 futility_memo_enabled: bool = True,
                 incremental_dirty_threshold: float = INCREMENTAL_DIRTY_THRESHOLD) -> None:
        self.framework = framework
        # the clock pods age on (first sightings, the aged rescue); a
        # caller that runs on virtual time passes its own
        self.clock = clock
        # off runs the uncached simulation / every futile trial: the
        # bench's and the tests' oracles
        self.verdict_cache_enabled = verdict_cache_enabled
        self.futility_memo_enabled = futility_memo_enabled
        # above this dirty share of the nodes, replan from scratch
        self.incremental_dirty_threshold = incremental_dirty_threshold
        # the effective size a second of waiting adds (the config's aging)
        self.aging_per_second = AGING_PER_SECOND
        self.last_plan_mode = "full"
        # namespaced name → reason, for every pending pod the last plan
        # could not serve
        self.last_unserved: Dict[str, str] = {}
        self.last_pending_ages: Dict[str, float] = {}
        # the last plan's slice tracker (the auditor re-sums its totals)
        self.last_tracker: Optional[SliceTracker] = None
        # True while this planner fronts for a pool planned on a worker
        # process, whose verdict cache and futility memo live there: the
        # auditor skips its cache checks
        self.memos_remote = False
        # (namespaced name, uid) → (first seen, last seen) on the clock;
        # pruned after PENDING_TTL_S unseen
        self._pending_seen: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._cache_snapshot: Optional[ClusterSnapshot] = None
        self._reset_plan_caches(None)

    # ------------------------------------------------------ plan caches

    def _reset_plan_caches(self, snapshot: Optional[ClusterSnapshot]) -> None:
        self._cache_snapshot = snapshot
        self._verdict_cache = VerdictCache()
        # id(pod) → (pod, signature); the pod reference pins the id
        self._signature_cache: Dict[int, tuple] = {}
        # (node name, version) → simulated NodeInfo
        self._node_info_cache: Dict[Tuple[str, int], NodeInfo] = {}
        # (request items, state_version) → still lacking
        self._lacking_cache: Dict[Tuple[tuple, int], bool] = {}
        # id(pod) → (pod, sorted request items)
        self._request_cache: Dict[int, tuple] = {}
        # state_version → candidate order
        self._candidate_cache: Optional[Tuple[int, List[str]]] = None
        # (node name, version, sorted lacking items) → the lacking reason:
        # a carve of that node state toward that profile changed nothing
        self._futility_cache: Dict[Tuple[str, int, tuple], str] = {}
        self._futility_hits = 0
        fw = self.framework
        self._cacheable_pre = [p for p in fw.pre_filter_plugins if is_verdict_cacheable(p)]
        self._uncacheable_pre = [p for p in fw.pre_filter_plugins
                                 if not is_verdict_cacheable(p)]
        self._cacheable_filters = [p for p in fw.filter_plugins if is_verdict_cacheable(p)]
        self._uncacheable_filters = [p for p in fw.filter_plugins
                                     if not is_verdict_cacheable(p)]

    def _ensure_plan_caches(self, snapshot: ClusterSnapshot) -> None:
        # identity: the memo keys hold this snapshot's clock values
        if snapshot is not self._cache_snapshot:
            self._reset_plan_caches(snapshot)

    def _prune_plan_caches(self, snapshot: ClusterSnapshot, pending_pods: List[Pod]) -> None:
        """Incremental mode: drop exactly the memo entries a refreshed node
        or a new state can no longer reach; an entry whose version key
        matches its live node describes the same state (``refresh_node``
        stamps fresh ticks, the outer revert restores the base's). The
        counters restart: they stay per plan."""
        self._verdict_cache.reset_stats()
        self._futility_hits = 0
        version_of = snapshot.node_version
        entries = self._verdict_cache.entries
        for key in [k for k in entries if version_of(k[1]) != k[2]]:
            del entries[key]
        for cache in (self._node_info_cache, self._futility_cache):
            for key in [k for k in cache if version_of(k[0]) != k[1]]:
                del cache[key]
        state_version = snapshot.state_version
        lacking = self._lacking_cache
        for key in [k for k in lacking if k[1] != state_version]:
            del lacking[key]
        if self._candidate_cache is not None and self._candidate_cache[0] != state_version:
            self._candidate_cache = None
        live = {id(p) for p in pending_pods}
        for cache in (self._signature_cache, self._request_cache):
            for key in [k for k in cache if k not in live]:
                del cache[key]

    def _select_plan_mode(self, snapshot: ClusterSnapshot, dirty: Optional[set]) -> str:
        if dirty is None:
            return "full"
        if snapshot is not self._cache_snapshot:
            # another snapshot's clock: no memo key means anything
            return "fallback"
        total = snapshot.node_count()
        if total and len(dirty) <= self.incremental_dirty_threshold * total:
            return "incremental"
        return "fallback"

    def verdict_cache_stats(self) -> Tuple[int, int, int]:
        """(hits, misses, bypasses) of the last plan()."""
        return self._verdict_cache.stats()

    # ------------------------------------------------------ hand-offs

    def adopt_pending_seen(self, other: "Planner") -> None:
        """Take ``other``'s first sightings, keeping the earlier of two."""
        for key, value in other._pending_seen.items():
            mine = self._pending_seen.get(key)
            if mine is None or value[0] < mine[0]:
                self._pending_seen[key] = value

    def export_warm_state(self, snapshot: ClusterSnapshot) -> Dict[str, dict]:
        """node → {"futility": [[lacking items, reason]], "verdicts":
        [[pod signature, verdict]]}, the entries keyed at the node's
        current version only: a trial fork's versions name hypothetical
        states."""
        version_of = snapshot.node_version
        out: Dict[str, dict] = {}
        for (node, version, lacking), reason in self._futility_cache.items():
            if version_of(node) == version:
                out.setdefault(node, {"futility": [], "verdicts": []})["futility"].append(
                    [[list(item) for item in lacking], reason])
        for (signature, node, version), verdict in self._verdict_cache.entries.items():
            if version_of(node) == version:
                out.setdefault(node, {"futility": [], "verdicts": []})["verdicts"].append(
                    [_relist(signature), bool(verdict)])
        return out

    def adopt_warm_state(self, snapshot: ClusterSnapshot, entries: Dict[str, dict]) -> int:
        """Re-key exported entries at ``snapshot``'s live versions and make
        it this planner's memo snapshot; the entries adopted."""
        self._reset_plan_caches(snapshot)
        adopted = 0
        for node, memos in entries.items():
            version = snapshot.node_version(node)
            if version < 0:
                continue
            for lacking, reason in memos.get("futility", ()):
                self._futility_cache[(node, version, _retuple(lacking))] = reason
                adopted += 1
            for signature, verdict in memos.get("verdicts", ()):
                self._verdict_cache.put((_retuple(signature), node, version), bool(verdict))
                adopted += 1
        return adopted

    # ----------------------------------------------------------- entry

    def plan(self, snapshot: ClusterSnapshot, pending_pods: List[Pod],
             pending_ages: Optional[Dict[str, float]] = None,
             dirty: Optional[set] = None) -> PartitioningState:
        """The desired partitioning for ``pending_pods``. With ``dirty``
        None the snapshot is left carrying the plan's carves and
        simulated placements; with ``dirty`` (the nodes refreshed since
        the last plan) it is left as it was. ``pending_ages`` (namespaced
        name → seconds pending) overrides the planner's own first-seen
        bookkeeping."""
        started = time.monotonic()
        mode = self._select_plan_mode(snapshot, dirty)
        with TRACER.span("partitioner.plan", pending_pods=len(pending_pods),
                         nodes=snapshot.node_count(), plan_mode=mode,
                         dirty_nodes=-1 if dirty is None else len(dirty)) as span:
            if mode == "incremental":
                self._prune_plan_caches(snapshot, pending_pods)
            else:
                self._reset_plan_caches(snapshot)
            self.last_plan_mode = mode
            metrics.PLAN_MODE.labels(mode=mode).inc()
            if dirty is not None:
                # warm the free pool before the fork checkpoints it, or the
                # revert throws it away and every plan recomputes it
                snapshot.free_slice_resources()
                snapshot.fork()
            try:
                return self._plan(snapshot, pending_pods, span, pending_ages)
            finally:
                if dirty is not None:
                    snapshot.revert()
                metrics.PLAN_DURATION.observe(time.monotonic() - started)
                hits, misses, bypasses = self._verdict_cache.stats()
                for event, n in (("hit", hits), ("miss", misses), ("bypass", bypasses)):
                    if n:
                        metrics.PLAN_VERDICT_CACHE.labels(event=event).inc(n)
                if self._futility_hits:
                    metrics.PLAN_CARVE_FUTILITY.inc(self._futility_hits)
                span.set_attributes(verdict_cache_hits=hits, verdict_cache_misses=misses,
                                    verdict_cache_bypasses=bypasses,
                                    carve_futility_hits=self._futility_hits)

    def _trial_cache_delta(self, before: Tuple[int, int, int]) -> dict:
        hits, misses, bypasses = self._verdict_cache.stats()
        return {"cache_hits": hits - before[0], "cache_misses": misses - before[1],
                "cache_bypasses": bypasses - before[2]}

    def _plan(self, snapshot: ClusterSnapshot, pending_pods: List[Pod], span,
              pending_ages: Optional[Dict[str, float]]) -> PartitioningState:
        self.last_unserved = {}
        now = time.monotonic() if self.clock is None else self.clock()
        if pending_ages is not None:
            pending_since = {p.namespaced_name: now - pending_ages.get(p.namespaced_name, 0.0)
                             for p in pending_pods}
        else:
            live = {(p.namespaced_name, p.uid) for p in pending_pods}
            for key in live:
                first, _ = self._pending_seen.get(key, (now, now))
                self._pending_seen[key] = (first, now)
            self._pending_seen = {k: v for k, v in self._pending_seen.items()
                                  if now - v[1] <= PENDING_TTL_S}
            pending_since = {k[0]: v[0] for k, v in self._pending_seen.items() if k in live}
        self.last_pending_ages = {k: now - v for k, v in pending_since.items()}
        # the tracker's pool draw order is the claim pre-pass's order
        candidates = sort_candidate_pods(pending_pods, self.aging_per_second,
                                         pending_since=pending_since, now=now)
        aged = {p.namespaced_name for p in candidates
                if (now - pending_since.get(p.namespaced_name, now)) * self.aging_per_second
                >= AGED_RESCUE_SIZE}
        tracker = self.last_tracker = SliceTracker(snapshot, candidates)
        if tracker.empty and not tracker.split:
            # the geometry already serves every pending pod (planner.go:80-83)
            return snapshot.partitioning_state()
        excluded_reasons: Dict[str, str] = {}
        if any(gang_of(p) for p in candidates):
            # bound members counted on the pristine snapshot, so trial
            # placements never double as bound members
            sizes, bound = self._gang_membership(snapshot, candidates)
            snapshot.fork()
            trial_tracker = SliceTracker(snapshot, candidates)
            trial_placed = self._plan_pass(snapshot, trial_tracker, candidates, aged)
            excluded = self._half_formable_gangs(sizes, bound, trial_placed)
            if not excluded:
                # the real pass would start from the same state in the same
                # order: the trial is the plan
                snapshot.commit()
                self.last_tracker = trial_tracker
                self._set_unserved(trial_tracker, candidates, trial_placed)
                span.set_attributes(gang_trial_reused=True)
                return snapshot.partitioning_state()
            snapshot.revert()
            log.info("planner: gangs %s cannot fully form; excluding their pods",
                     sorted(excluded))
            excluded_reasons = {p.namespaced_name: gang_excluded_reason(gang_of(p)[0])
                                for p in candidates if (gang_of(p) or (None,))[0] in excluded}
            candidates = [p for p in candidates if p.namespaced_name not in excluded_reasons]
            tracker = self.last_tracker = SliceTracker(snapshot, candidates)
            if tracker.empty and not tracker.split:
                self.last_unserved = excluded_reasons
                return snapshot.partitioning_state()
        placed = self._plan_pass(snapshot, tracker, candidates, aged)
        self._set_unserved(tracker, candidates, placed, excluded_reasons)
        span.set_attributes(totals_calls=tracker.totals_calls,
                            totals_recomputes=tracker.totals_recomputes)
        return snapshot.partitioning_state()

    def _set_unserved(self, tracker: SliceTracker, candidates: List[Pod], placed: List[Pod],
                      extra: Optional[Dict[str, str]] = None) -> None:
        """``last_unserved``: ``extra`` (the excluded gangs' reasons), then
        each candidate asking for slices that the pass left unplaced."""
        self.last_unserved = dict(extra or {})
        placed_keys = {p.namespaced_name for p in placed}
        for p in candidates:
            if p in tracker:
                reason = lacking_reason(tracker.lacking_for(p))
            elif p.namespaced_name in placed_keys or not self._claims_free_slices(p):
                continue
            else:
                # the pass put every unplaced pod asking for this mode's
                # slices back in the tracker: this one asks for another
                # mode's, which no node here holds
                reason = unplaced_reason(res.compute_pod_request(p))
            self.last_unserved[p.namespaced_name] = reason

    @staticmethod
    def _gang_membership(snapshot: ClusterSnapshot, candidates: List[Pod]
                         ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(gang → declared size, gang → members on any node of the
        snapshot), for the gangs of the candidates."""
        sizes: Dict[str, int] = {}
        for pod in candidates:
            gang = gang_of(pod)
            if gang:
                sizes[gang[0]] = gang[1]
        bound: Dict[str, int] = {}
        for node in snapshot.get_nodes().values():
            for pod in node.pods:
                gang = gang_of(pod)
                if gang:
                    bound[gang[0]] = bound.get(gang[0], 0) + 1
        return sizes, bound

    @staticmethod
    def _half_formable_gangs(sizes: Dict[str, int], bound: Dict[str, int],
                             trial_placed: List[Pod]) -> set:
        """The gangs whose bound and trial-placed members fall short."""
        placed: Dict[str, int] = {}
        for pod in trial_placed:
            gang = gang_of(pod)
            if gang:
                placed[gang[0]] = placed.get(gang[0], 0) + 1
        return {key for key, size in sizes.items()
                if bound.get(key, 0) + placed.get(key, 0) < size}

    def _plan_pass(self, snapshot: ClusterSnapshot, tracker: SliceTracker,
                   candidates: List[Pod], aged: set) -> List[Pod]:
        """One pass; the pods it placed."""
        self._ensure_plan_caches(snapshot)
        placed: List[Pod] = []
        # Aged rescue, before anyone claims free slices: one rescue a plan
        # (each fragments a free region), failed tries capped at three.
        rescued = attempts = 0
        for pod in candidates:
            if not aged or rescued >= 1 or attempts >= 3:
                break
            if pod.namespaced_name not in aged or pod not in tracker:
                continue
            attempts += 1
            for node_name in self._candidate_nodes(snapshot):
                lacking = tracker.lacking_for(pod)
                futility_key = self._futility_key(snapshot, node_name, lacking)
                if self._futile(futility_key):
                    continue
                stats_before = self._verdict_cache.stats()
                with TRACER.span("plan.trial", node=node_name, rescue=True) as trial:
                    snapshot.fork()
                    if not snapshot.update_geometry_for(node_name, lacking):
                        self._note_futile(futility_key, lacking)
                        trial.set_attributes(committed=False, nodes_copied=snapshot.revert(),
                                             **self._trial_cache_delta(stats_before))
                        continue
                    if self._try_add_pod(snapshot, node_name, pod):
                        tracker.remove(pod)
                        placed.append(pod)
                        rescued += 1
                        trial.set_attributes(committed=True, nodes_copied=snapshot.commit(),
                                             **self._trial_cache_delta(stats_before))
                        log.info("planner: node %s re-carved (aged rescue) for %s",
                                 node_name, pod.namespaced_name)
                        break
                    trial.set_attributes(committed=False, nodes_copied=snapshot.revert(),
                                         **self._trial_cache_delta(stats_before))

        # Claim pre-pass: pods the free slices already serve are placed
        # first, so the carve loop sees their slices as used. The rescued
        # pod is placed already.
        rescued_pods = {p.namespaced_name for p in placed}
        for pod in candidates:
            if pod in tracker or pod.namespaced_name in rescued_pods:
                continue
            claims_slices = self._claims_free_slices(pod)
            for node_name in self._candidate_nodes(snapshot):
                # a node with no free slice cannot serve a slice-consuming
                # pod: add_pod's own no-fit precondition
                if claims_slices and not snapshot.node_has_free_slices(node_name):
                    continue
                if self._try_add_pod(snapshot, node_name, pod):
                    placed.append(pod)
                    break

        # F3: a pod the pre-pass could not place lacks its whole request,
        # however the free slices cover it (they may lie on several nodes)
        placed_keys = {p.namespaced_name for p in placed}
        for pod in candidates:
            if pod not in tracker and pod.namespaced_name not in placed_keys:
                lacking = snapshot.take_from_pool({}, res.compute_pod_request(pod))
                if lacking:
                    tracker.add(pod, lacking)

        # The carve loop.
        for node_name in self._candidate_nodes(snapshot):
            if tracker.empty:
                break
            lacking = tracker.lacking_totals()
            futility_key = self._futility_key(snapshot, node_name, lacking)
            if self._futile(futility_key):
                continue
            stats_before = self._verdict_cache.stats()
            with TRACER.span("plan.trial", node=node_name) as trial:
                snapshot.fork()
                if not snapshot.update_geometry_for(node_name, lacking):
                    self._note_futile(futility_key, lacking)
                    trial.set_attributes(committed=False, nodes_copied=snapshot.revert(),
                                         **self._trial_cache_delta(stats_before))
                    continue
                placed_here = 0
                for pod in candidates:
                    if pod in tracker and self._try_add_pod(snapshot, node_name, pod):
                        tracker.remove(pod)
                        placed.append(pod)
                        placed_here += 1
                if placed_here:
                    trial.set_attributes(committed=True, pods_placed=placed_here,
                                         nodes_copied=snapshot.commit(),
                                         **self._trial_cache_delta(stats_before))
                    log.info("planner: node %s re-carved for pending pods", node_name)
                else:
                    trial.set_attributes(committed=False, nodes_copied=snapshot.revert(),
                                         **self._trial_cache_delta(stats_before))
        return placed

    # ------------------------------------------------------------------

    @staticmethod
    def _futility_key(snapshot: ClusterSnapshot, node_name: str, lacking: dict) -> tuple:
        # read the version before the trial's fork (get_nodes never journals)
        return node_name, snapshot.get_nodes()[node_name].version, tuple(sorted(lacking.items()))

    def _futile(self, key: tuple) -> bool:
        """The carve memo proved this trial a no-op."""
        if self.futility_memo_enabled and key in self._futility_cache:
            self._futility_hits += 1
            return True
        return False

    def _note_futile(self, key: tuple, lacking: dict) -> None:
        if self.futility_memo_enabled:
            self._futility_cache[key] = lacking_reason(lacking)

    def _candidate_nodes(self, snapshot: ClusterSnapshot) -> List[str]:
        """get_candidate_nodes, memoized on state_version."""
        cached = self._candidate_cache
        if cached is not None and cached[0] == snapshot.state_version:
            return cached[1]
        names = snapshot.get_candidate_nodes()
        self._candidate_cache = (snapshot.state_version, names)
        return names

    def _request_signature(self, pod: Pod) -> tuple:
        entry = self._request_cache.get(id(pod))
        if entry is None or entry[0] is not pod:
            entry = (pod, tuple(sorted(res.compute_pod_request(pod).items())))
            self._request_cache[id(pod)] = entry
        return entry[1]

    def _claims_free_slices(self, pod: Pod) -> bool:
        """Whether binding the pod must take a free slice (it names a MIG
        or MPS slice); such a pod cannot fit a node without one."""
        return any(qty and is_slice_resource(name)
                   for name, qty in self._request_signature(pod))

    def _has_lacking(self, snapshot: ClusterSnapshot, pod: Pod) -> bool:
        """bool(get_lacking_slices), memoized on (request, state_version)."""
        key = (self._request_signature(pod), snapshot.state_version)
        lacking = self._lacking_cache.get(key)
        if lacking is None:
            lacking = bool(snapshot.get_lacking_slices(pod))
            self._lacking_cache[key] = lacking
        return lacking

    def _try_add_pod(self, snapshot: ClusterSnapshot, node_name: str, pod: Pod) -> bool:
        self._ensure_plan_caches(snapshot)
        # the cluster still lacks slices for the pod: no simulation
        # (planner.go:155-175)
        if self._has_lacking(snapshot, pod):
            return False
        if not self._can_schedule(snapshot, node_name, pod):
            return False
        return snapshot.add_pod(node_name, pod)

    def _can_schedule(self, snapshot: ClusterSnapshot, node_name: str, pod: Pod) -> bool:
        """The real scheduler plugins against the node's simulated view
        (planner.go:178-207), through the verdict cache."""
        self._ensure_plan_caches(snapshot)
        # read through get_nodes(): nothing here may journal the node
        node = snapshot.get_nodes()[node_name]
        # a verdict that reads other nodes has no single-node key
        bypass = needs_cluster_context(pod) or snapshot.has_anti_affinity_pods()
        if not self.verdict_cache_enabled:
            return self._run_simulation(node, pod, snapshot if bypass else None)
        if bypass:
            self._verdict_cache.bypasses += 1
            return self._run_simulation(node, pod, snapshot)
        key = (self._simulation_signature(pod), node_name, node.version)
        verdict = self._verdict_cache.get(key)
        if verdict is None:
            verdict = self._run_simulation(node, pod, pre=self._cacheable_pre,
                                           filters=self._cacheable_filters)
            self._verdict_cache.put(key, verdict)
        if not verdict:
            return False
        if not self._uncacheable_pre and not self._uncacheable_filters:
            return True
        # plugins that never opted in run on every trial; their verdict
        # ANDs with the cached one
        return self._run_simulation(node, pod, pre=self._uncacheable_pre,
                                    filters=self._uncacheable_filters)

    def _run_simulation(self, node: SnapshotNode, pod: Pod,
                        published: Optional[ClusterSnapshot] = None, pre=None,
                        filters=None) -> bool:
        """One PreFilter + Filter run (the whole chains, or the subsets
        given) against the node's simulated view; with ``published``, that
        snapshot's whole view is published for the filters that read it."""
        state = CycleState()
        if published is not None:
            state[TOPOLOGY_NODE_INFOS_KEY] = published.sim_node_infos()
        status = self.framework.run_pre_filter_plugins(state, pod, plugins=pre)
        if not status.success:
            return False
        status = self.framework.run_filter_plugins(state, pod, self._node_info(node),
                                                   plugins=filters)
        return status.success

    def _node_info(self, node: SnapshotNode) -> NodeInfo:
        """node.sim_node_info(), memoized on (name, version); the filters
        treat it as read-only."""
        key = (node.name, node.version)
        info = self._node_info_cache.get(key)
        if info is None:
            info = node.sim_node_info()
            self._node_info_cache[key] = info
        return info

    def _simulation_signature(self, pod: Pod) -> tuple:
        """The pod's verdict-cache signature, once per pod and plan. The
        simulation pod is the pod itself: no request is normalized to a
        node's generation here."""
        entry = self._signature_cache.get(id(pod))
        if entry is None or entry[0] is not pod:
            entry = (pod, pod_signature(pod))
            self._signature_cache[id(pod)] = entry
        return entry[1]
