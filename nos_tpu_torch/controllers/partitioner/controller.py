"""PartitionerController: pending pods → batch → snapshot → plan → actuate.

Counterpart of ``nos_tpu/controllers/partitioner/controller.py``
(reference internal/controllers/gpupartitioner/partitioner_controller.go:81-239):
``fetch_pending_pods`` (``:399``), ``process_pending_pods`` (``:427``:
snapshot, plan, actuate), ``_record_plan`` (``:1016``), the divergence
reconcile (``:226-291``) and the capacity-freed trigger (``:293-311``),
with the batcher's windows (60 s and 10 s by default) and the plan-id
gate.

``step()`` runs the cycle on the caller's clock. Its ``sync`` first
brings ``ClusterState`` up to the store through the reference's node and
pod state controllers (``node_controller.py``, ``pod_controller.py``,
which give a MIG node with no geometry yet its first one through
``MigNodeInitializer``): ``state_feed``, the drain of those controllers'
watches; a ``SimCluster`` passes its ``Manager``'s, and a controller
given none drains a private ``Manager`` of its own. The gate and the
mode check read that state; the snapshot reads the store (below). The step then adds every
pending pod that re-partitioning could help and that asks for this
mode's resources to the batch, and processes the batch once a window has
passed. The gate: no plan while a
node of this mode has not acknowledged its last one (its
``status-partitioning-plan``, written by the node's MIG agent or MPS
reporter, differs from its ``spec-partitioning-plan``);
a released batch waits for the gate, so the loop never re-carves a GPU
mid-change. After each plan the pods still pending go back into the
batch (the reference's level-triggered retry).

Two triggers fire the batch at once, polled in ``step`` for
``SimCluster`` (the watch path's are below). *Capacity freed*: a pod
holding this mode's resources on a node that has finished (Succeeded or Failed) or been deleted since the last
step, with a pending pod re-partitioning could help (the reference calls
the freed window "the single largest utilization tax in a steady stream
of short jobs"). While a pending pod is nominated to a node whose
capacity was freed, that room is a preemption's, freed for that pod: the
trigger waits until the scheduler's next cycle has bound the pod or
handed it back (a nominee that needs a re-carve fails once and loses
its nomination), then fires. The reference fires at once and leaves
the order to its threads; in the polled loop the plan would always
come first and carve the nominee's room for other pods. *Divergence*
(the MIG mode only, as the reference wires it to its TPU controller
alone; an MPS node's plan is a config map, with no spec geometry to
diverge from): a node that acknowledged its plan but
reports another geometry (its agent could not create the plan) fires one
replan per plan id (``_diverged``), and with nothing pending its spec
adopts the reported geometry under the same plan id. F4's refusal memo
(``partitioning/mig.py``) keeps the replan from asking for the refused
geometry again. Each is checked for every node of the mode on every
step, from the node's parsed annotations memoized on its stored object.

The watch path (the partitioner component, ``cmd/partitioner.py``,
wiring the reference's ``controller.py:179-240``, ``:315-355``):
``reconcile(req)`` on the pending-pod watch adds a pod to the batch, or
requeues it with the reference's age-proportional delay while no node of
this mode is known; ``reconcile_freed_event`` and
``reconcile_divergence_event`` are the two triggers on the pod and node
watches, firing at once (the polled nominee wait is ``step``'s alone);
``start()`` runs the batch thread, which sleeps on ``Batcher.wait``,
waits for the plan gate, plans, and puts the pods still pending back in
the batch; ``stop()`` ends it. There, ``ClusterState`` is fed by the
component's threaded state controllers (``state_feed`` does nothing),
the batch windows run on the monotonic clock and a pod's age on the
store's. One lock serializes the watch threads and the batch thread
over the batch, the divergence memo and the snapshot maintainers;
``step()`` takes none (it has no other thread). ``scheduler_name``, when
given, keeps the pods of other schedulers out of the plans.

Incremental planning (``incremental_planning``, on by default, as in
the reference, ``:59-60``, ``:440-470``): an
``IncrementalSnapshotMaintainer`` keeps one base snapshot and hands the
planner the nodes refreshed since its last plan (``plan(...,
dirty=...)``, which leaves the base as observed). Off, every plan takes
a whole snapshot and consumes it. ``incremental_dirty_threshold`` sets
the planner's.

Pool sharding (``pool_sharding``, off by default as in the reference,
``api/config/v1alpha1.py:64-86``; it needs incremental planning;
``:583-1015``): a ``PoolShardedMaintainer`` partitions the cluster into
pools no gang, selector or borrowing quota couples
(``partitioning/core/pools.py``) and keeps one snapshot and one planner a
pool; each pool is planned on its own and the merge is checked (no node
claimed twice or left out, no GPU listed twice, no node past its
capacity) before it is actuated. A failed check actuates a no-op and
rebuilds the pools next plan (``PLAN_MERGE_CONFLICTS``). ``pool_backend``
picks where the pools are planned: ``""`` or ``serial`` in this process,
one after another (the default), or ``process``, on a worker process a
pool (``procpool.PoolWorkerPool.plan_pools``, which owns the wire
protocol), given each quota's usage outside the pool and the pending
holders of the pool's drain reservations. A worker that misses
``pool_cycle_timeout_seconds`` (a wall-clock liveness deadline, the one
here), dies or speaks a bad frame is dropped; its pool is planned in the
parent that cycle (the same plan) and the pools rebuild, so the next
plan respawns it. A framework ``framework_spec`` cannot ship plans
serially, with a warning. The reference's ``pool_parallelism`` (threads)
is left out: the planner is pure Python, threads plan no faster than one
after another (``bench_planner.py --plan-mode sharded``, which keeps that
mode to measure it). ``PLAN_BACKEND`` counts the pools by backend
(``escalated`` for the parent's plans of a dead worker's pool),
``PLAN_POOL_COUNT`` and ``PLAN_POOL_DURATION`` the pools.
The plan record gives the pools, each pool's backend and milliseconds,
the merge's milliseconds and, on the process backend, the frame bytes.
The divergence reconcile, the capacity-freed trigger and the plan-id
gate do not change. A started controller's batch loop is sampled by the
profiler and beats the watchdog (``partitioner-<kind>``, its plans
applied the counter); its verdict cache and futility memo are the
timeline's ``size.planner.<kind>.*`` series.

Warm state (``warm_state_path``, ``:1016-1094``; ``snapcodec.py``):
after a plan the planners' futility proofs and verdicts are saved beside
each node's state signature, at most once per
``warm_state_save_interval_seconds`` on ``clock``; a new base (a start,
a rebuild) adopts the entries of every node whose signature still
matches and plans only the others as dirty. ``WARM_BOOT_OUTCOME`` counts
``adopted``, ``partial`` and ``cold``; ``last_warm_boot`` holds the last
report. ``close()`` stops the workers.

Spans: ``partitioner.process``, ``snapshot.take``, ``partitioner.plan``
and ``plan.trial`` (the planner's), ``partitioner.actuate``. Counters:
``PLANS_APPLIED`` and ``DIVERGENCE_REPLANS`` here, ``plans_applied``
and ``nodes_repartitioned`` (each node a plan re-partitioned, the bench's
re-carves), ``PLAN_DURATION`` / ``PLAN_MODE`` / ``PLAN_VERDICT_CACHE`` /
``PLAN_CARVE_FUTILITY`` in the planner, ``SNAPSHOT_FORKS`` / ``COMMITS``
/ ``REVERTS`` in the snapshot. ``last_unserved``, ``last_pending_ages``
and ``last_plan_mode`` give the last plan's ledger (the pools' merged,
when sharded); ``plans`` keeps the last ``PLAN_RECORDS`` plans' records.
``multihost.py``'s counterpart is ``multinode.py``.

Records, audits and events (the reference's ``:541-558``, ``:610``,
``:722-754``, ``:904``, ``:936-940``, ``:1016-1090``): with a
``FlightRecorder`` each plan writes ``planner.plan`` (the store revision
read before the snapshot, the pending pods and their ages, the desired
state, the reasons) and ``actuation``, and a pool a worker could not
serve ``pool.escalation``; with an ``InvariantAuditor`` a sample of the
plans is audited after the ledger's observation (``audit_plan``, or
``audit_sharded_plan`` over each pool's planner, snapshot, pending pods
and desired state, a worker's pool behind its parent-side planner),
``audit_violations`` set on the ``partitioner.process`` span; with an
``EventRecorder`` a pod the plan could not serve records ``CarveFailed``
once a reason and a served pod of a plan that re-partitioned
``PartitioningApplied``. Every cycle, recorded or not, reads its
pending pods, its watermark and its snapshot and plans under one hold
of the store, and snapshots the store itself, as the reference does
(``take_snapshot(..., store=)``), not the watch-fed state; a worker's
pool is audited with its cache checks counted as skipped (its memos
live in the worker).
With a ``capacity_ledger`` the controller observes it after each plan
(on its clock, with the plan's unserved reasons), and with a
``forecaster`` it notifies it of the cycle's pending pods, at the
reference's points (``nos_tpu/controllers/partitioner/controller.py:520-540``);
the forecast itself runs off the plan path (``SimCluster``).
``build_sim_framework`` (``nos_tpu/cmd/partitioner.py:39-66``) gives a
planner the scheduler's filters and its quota PreFilter.

Gang members waiting in the scheduler's Permit hold their slices only in
its assume cache: the store, so the snapshot, shows those slices free.
As in the reference (``:398-424``), they stay pending candidates (they
carry no Unschedulable condition, but a plan that left them out could
carve their slices away): the free pool covers them like any pod the
free slices serve, and the claim pre-pass places them on free slices
instead of carving for them.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import ExitStack
from typing import Callable, Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.controllers.partitioner.incremental import (
    IncrementalSnapshotMaintainer,
    PoolShardedMaintainer,
)
from nos_tpu_torch.controllers.partitioner.node_controller import add_state_controllers
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.node import PARTITIONING_MIG
from nos_tpu_torch.kube.controller import Manager, Request, Result
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import (
    Actuator,
    ClusterState,
    PartitioningPlan,
    Planner,
)
from nos_tpu_torch.partitioning.core.partition_state import (
    PartitioningState,
    partitioning_state_to_dict,
)
from nos_tpu_torch.partitioning.core.pools import (
    check_merge_invariants,
    merge_pool_states,
    node_capacities,
    plan_pool,
    split_pending,
)
from nos_tpu_torch.partitioning.core.snapcodec import AdoptReport, WarmStateCodec
from nos_tpu_torch.partitioning.core.state import StoreState, partitioning_kind
from nos_tpu_torch.scheduler.framework import Framework, vanilla_filter_plugins
from nos_tpu_torch.scheduler.plugins.capacity import (
    CapacityScheduling,
    build_quota_infos,
    quota_request,
)
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR, BoardReservation
from nos_tpu_torch.scheduler.plugins.topology import MultinodeFilter
from nos_tpu_torch.timeline.sizes import SIZES
from nos_tpu_torch.timeline.watchdog import WATCHDOG
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import resources as res
from nos_tpu_torch.util.pod import is_preempting
from nos_tpu_torch.util.batcher import DEFAULT_IDLE_SECONDS, DEFAULT_TIMEOUT_SECONDS, Batcher
from nos_tpu_torch.util.loop_health import LOOPS, BusyMeter
from nos_tpu_torch.util.profiling import PROFILER
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.partitioner")

PLAN_RECORDS = 64
POOL_BACKENDS = ("", "serial", "process")


def could_help(pod: Pod) -> bool:
    """Re-partitioning could make the pod schedulable: it is pending,
    unbound, marked Unschedulable and not preempting its way onto a node
    (reference pkg/util/pod/pod.go:25-33)."""
    return (pod.phase == PodPhase.PENDING and not pod.node and pod.unschedulable
            and not is_preempting(pod))


def build_sim_framework(store: NodeStore) -> Framework:
    """The planner's simulation framework: the plugins the scheduler's own
    cycle filters with, so a plan never carves for a pod the scheduler
    would refuse (``nos_tpu/cmd/partitioner.py:build_sim_framework``):
    ``CapacityScheduling`` as PreFilter, the vanilla filters,
    ``MultinodeFilter`` (a gang's bound members pin its pool; members
    placed within one plan are not pinned, and a split across pools
    resolves by the Permit timeout and a replan, as in the reference) and
    ``BoardReservation`` (nothing is carved for another pod on a draining
    node). None of the three store readers makes a verdict-cache promise:
    they run on every trial."""
    return Framework(pre_filter_plugins=[CapacityScheduling(store)],
                     filter_plugins=vanilla_filter_plugins()
                     + [MultinodeFilter(store), BoardReservation(store)])


def _default_plan_id() -> str:
    return str(int(time.time() * 1000))


class PartitionerController:
    def __init__(self, store: NodeStore, cluster_state: ClusterState, snapshot_taker,
                 planner: Planner, actuator: Actuator, kind: str,
                 tracked_resource_fn: Callable[[str], bool],
                 batch_timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
                 batch_idle_seconds: float = DEFAULT_IDLE_SECONDS,
                 plan_id_fn: Callable[[], str] = _default_plan_id,
                 initializer=None, clock: Callable[[], float] = time.monotonic,
                 incremental_planning: bool = True,
                 incremental_dirty_threshold: Optional[float] = None,
                 pool_sharding: bool = False, pool_backend: str = "",
                 pool_cycle_timeout_seconds: float = 5.0, warm_state_path: str = "",
                 warm_state_save_interval_seconds: float = 30.0,
                 capacity_ledger=None, forecaster=None,
                 state_feed: Optional[Callable[[], object]] = None,
                 scheduler_name: str = "", recorder=None, flight_recorder=None,
                 auditor=None) -> None:
        self.store = store
        # an EventRecorder (CarveFailed, PartitioningApplied), a
        # FlightRecorder (planner.plan, actuation, pool.escalation) and an
        # InvariantAuditor (record/audit.py), each optional
        self.recorder = recorder
        self.flight_recorder = flight_recorder
        self.auditor = auditor
        # pod key → the carve-failure reason last evented (no repeat)
        self._last_carve_reason: Dict[str, str] = {}
        # non-empty: plan only for the pods this scheduler binds
        self.scheduler_name = scheduler_name
        # the watch entry points and the batch thread take it (step does not)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = BusyMeter(f"partitioner-{kind}")
        self.clock = clock
        self.capacity_ledger = capacity_ledger
        self.forecaster = forecaster
        self.cluster_state = cluster_state
        self.snapshot_taker = snapshot_taker
        self.planner = planner
        self.actuator = actuator
        self.kind = kind
        self.tracked_resource_fn = tracked_resource_fn
        self.plan_id_fn = plan_id_fn
        self.initializer = initializer
        if state_feed is None:
            # its own state controllers, drained at each sync
            self.state_manager = Manager(store)
            names = add_state_controllers(self.state_manager, cluster_state, initializer,
                                          kind, suffix=f"-{kind}", clock=clock)
            state_feed = lambda: self.state_manager.drain(names)  # noqa: E731
        self._feed = state_feed
        self.batcher: Batcher[str] = Batcher(batch_timeout_seconds, batch_idle_seconds, clock)
        self._batched: set = set()
        self._released = False  # a released batch waiting for the gate
        self.plans_applied = 0
        self.plans_processed = 0
        self.nodes_repartitioned = 0
        self.last_applied = 0
        self.plans: Deque[dict] = deque(maxlen=PLAN_RECORDS)
        self.incremental_planning = incremental_planning
        if incremental_dirty_threshold is not None:
            self.planner.incremental_dirty_threshold = incremental_dirty_threshold
        self.maintainer: Optional[IncrementalSnapshotMaintainer] = None
        # pod key → (uid, node) of the pods holding this mode's resources
        self._holding: Dict[str, Tuple[str, str]] = {}
        # nodes whose capacity was freed since the trigger last looked
        self._freed: set = set()
        self.capacity_freed_fires = 0
        # divergence: node → the spec plan id already replanned for, and
        # node → (node object, its parsed annotations)
        self._diverged: Dict[str, str] = {}
        self._parsed: Dict[str, tuple] = {}
        # the last plan's ledger (the pools' merged when sharded)
        self.last_unserved: Dict[str, str] = {}
        self.last_pending_ages: Dict[str, float] = {}
        self.last_plan_mode = "full"
        # pool sharding
        if pool_backend not in POOL_BACKENDS:
            raise ValueError(f"pool_backend {pool_backend!r} is not one of {POOL_BACKENDS}")
        self.pool_sharding = pool_sharding and incremental_planning
        self.pool_backend = pool_backend
        self.pool_cycle_timeout_seconds = pool_cycle_timeout_seconds
        self.shard_maintainer: Optional[PoolShardedMaintainer] = None
        self.last_partition = None
        self._pool_planners: Dict[str, Planner] = {}
        self._worker_pool = None
        self._process_disabled = False  # framework_spec refused the framework
        # warm state
        self._warm_codec = (WarmStateCodec(warm_state_path, warm_state_save_interval_seconds,
                                           clock)
                            if warm_state_path and incremental_planning else None)
        self._last_base = None  # the unsharded base last planned
        self.last_warm_boot: Optional[dict] = None

    # ------------------------------------------------------------ sync

    def sync(self) -> None:
        """ClusterState catches up with the store (the state controllers'
        watches drained), then the capacity-freed trigger notes the nodes
        where a pod holding this mode's resources finished or went."""
        self._feed()
        holding: Dict[str, Tuple[str, str]] = {}
        for node, pods in self.store.pods_by_node().items():
            for pod in pods:
                if self.requests_tracked_resources(pod):
                    holding[pod.namespaced_name] = (pod.uid, node)
        # held last step, not now: finished, deleted or recreated
        self._freed.update(node for k, (uid, node) in self._holding.items()
                           if holding.get(k, ("",))[0] != uid)
        self._holding = holding

    def gate_open(self) -> bool:
        """Every node of this mode has acknowledged its last plan."""
        for info in self.cluster_state.read_view().values():
            if partitioning_kind(info.node) != self.kind:
                continue
            spec = info.node.annotations.get(annot.SPEC_PARTITIONING_PLAN)
            if spec and spec != info.node.annotations.get(annot.STATUS_PARTITIONING_PLAN):
                return False
        return True

    # ------------------------------------------------------------ step

    def requests_tracked_resources(self, pod: Pod) -> bool:
        return any(self.tracked_resource_fn(name) for name in res.compute_pod_request(pod))

    def _enqueue(self) -> None:
        if not self.cluster_state.is_partitioning_enabled(self.kind):
            return
        for pod in self.fetch_pending_pods():
            key = pod.namespaced_name
            if key not in self._batched and could_help(pod) \
                    and self.requests_tracked_resources(pod):
                self._batched.add(key)
                self.batcher.add(key)

    def step(self) -> int:
        """One poll: sync, batch, the two triggers, and process a due batch
        when the gate is open. The nodes re-partitioned."""
        self.sync()
        self._enqueue()
        if self.kind == PARTITIONING_MIG:
            for node in self.store.list("Node", copy=False):
                self.reconcile_node_divergence(node)
        if self._freed and not self._nominated_to(self._freed):
            self._freed.clear()
            self.reconcile_capacity_freed()
        if self.batcher.poll() is not None:
            self._released = True
            self._batched.clear()
        if not self._released or not self.gate_open():
            return 0
        self._released = False
        applied = self.process_pending_pods()
        self._enqueue()  # the pods still pending start the next window
        return applied

    # ----------------------------------------------------------- triggers

    def _could_be_helped(self) -> bool:
        return any(could_help(p) and self.requests_tracked_resources(p)
                   for p in self.fetch_pending_pods())

    def _nominated_to(self, nodes: set) -> bool:
        """A pending pod is nominated to one of ``nodes``: a preemption
        freed that room for it."""
        return any(p.nominated_node in nodes for p in self.fetch_pending_pods())

    def reconcile_capacity_freed(self) -> bool:
        """A pod holding this mode's resources finished or went: with a
        pending pod re-partitioning could help, fire the batch now."""
        if self._could_be_helped():
            self.capacity_freed_fires += 1
            self.batcher.fire_now()
            return True
        return False

    def _parsed_annotations(self, node: Node) -> tuple:
        """(spec plan, status plan, spec geometries, status geometries),
        memoized on the stored node object (replaced on every write)."""
        cached = self._parsed.get(node.name)
        if cached is not None and cached[0] is node:
            return cached[1]
        spec, status = annot.parse_node_annotations(node.annotations)
        parsed = (node.annotations.get(annot.SPEC_PARTITIONING_PLAN),
                  node.annotations.get(annot.STATUS_PARTITIONING_PLAN),
                  annot.spec_geometries(spec), annot.status_geometries(status))
        self._parsed[node.name] = (node, parsed)
        return parsed

    def reconcile_node_divergence(self, node: Node) -> str:
        """A node that acknowledged its plan but reports another geometry:
        replan once for that plan id, or, with nothing pending, let the
        spec adopt the reported geometry. What was done: "other_kind",
        "in_flight", "converged", "adopted", "replan" or
        "replanned_already"."""
        if partitioning_kind(node) != self.kind:
            return "other_kind"
        spec_plan, status_plan, wanted, have = self._parsed_annotations(node)
        if not spec_plan or spec_plan != status_plan:
            return "in_flight"  # the plan gate's business
        if wanted == have:
            self._diverged.pop(node.name, None)
            return "converged"
        if not self.fetch_pending_pods():
            # nothing to replan for: the intent adopts what exists, under
            # the same plan id, which the agent acknowledges as it stands
            patch: Dict[str, Optional[str]] = dict(annot.strip_spec_annotations(
                node.annotations))
            patch.update(annot.spec_from_geometries(have))
            metrics.DIVERGENCE_REPLANS.inc()
            log.info("partitioner: %s reports geometry diverging from plan %s with no "
                     "pending pods; spec adopts reported geometry", node.name, spec_plan)
            self.store.patch_annotations("Node", node.name, "", patch)
            return "adopted"
        if self._diverged.get(node.name) == spec_plan:
            return "replanned_already"
        self._diverged[node.name] = spec_plan
        metrics.DIVERGENCE_REPLANS.inc()
        log.info("partitioner: %s reports geometry diverging from plan %s; replanning now",
                 node.name, spec_plan)
        self.batcher.fire_now()
        return "replan"

    # ----------------------------------------------------- watch path

    def reconcile(self, req: Request) -> Optional[Result]:
        """The pending-pod watch: a pod re-partitioning could help joins
        the batch. While no node of this mode is known yet it is requeued,
        after a quarter of its age (1 to 30 s, on the store's clock): the
        node's event may still be behind the pod's."""
        pod = self.store.try_get("Pod", req.name, req.namespace, copy=False)
        if pod is None or not self.requests_tracked_resources(pod) or not could_help(pod):
            return None
        if self.scheduler_name and pod.scheduler_name != self.scheduler_name:
            return None
        if not self.cluster_state.is_partitioning_enabled(self.kind):
            age = max(0.0, self.store.clock() - (pod.created or self.store.clock()))
            return Result(requeue_after=min(30.0, max(1.0, age / 4.0)))
        with self._lock:
            if pod.namespaced_name not in self._batched:
                self._batched.add(pod.namespaced_name)
                self.batcher.add(pod.namespaced_name)
        return None

    def reconcile_divergence_event(self, req: Request) -> Optional[Result]:
        """The node watch's divergence check (``reconcile_node_divergence``
        on the node the request names); a node replanned for stays on a 1 s
        heartbeat, so the adopt path still runs once the pods drain."""
        node = self.store.try_get("Node", req.name, copy=False)
        with self._lock:
            if node is None:
                self._diverged.pop(req.name, None)
                return None
            outcome = self.reconcile_node_divergence(node)
        return Result(requeue_after=1.0) if outcome in ("replan", "replanned_already") else None

    def reconcile_freed_event(self, req: Request) -> Optional[Result]:
        """The pod watch's capacity-freed trigger: a bound pod finished or
        went; fire the batch at once when a pending pod could be helped."""
        with self._lock:
            self.reconcile_capacity_freed()
        return None

    def start(self) -> None:
        """The batch thread: it sleeps on the batcher, waits for the plan
        gate, then plans and puts the pods still pending back in the
        batch."""
        self._stop.clear()
        name = f"partitioner-{self.kind}"
        LOOPS.register(name, self._loop_stats)
        # event-driven (a batch opens when work arrives): stall-checked
        # only when armed; the memos are leak-watched (pruned by version
        # every cycle, so growth past pruning is the cross-cycle bug)
        WATCHDOG.register(name, periodic=False, thread_name=name,
                          counter_fn=lambda: self.plans_applied)
        SIZES.register(f"planner.{self.kind}.verdict_cache",
                       lambda: len(self.planner._verdict_cache.entries))
        SIZES.register(f"planner.{self.kind}.futility_memo",
                       lambda: len(self.planner._futility_cache))
        self._thread = threading.Thread(target=self._batch_loop, name=name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        LOOPS.unregister(f"partitioner-{self.kind}")
        WATCHDOG.unregister(f"partitioner-{self.kind}")
        SIZES.unregister(f"planner.{self.kind}.verdict_cache")
        SIZES.unregister(f"planner.{self.kind}.futility_memo")
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.close()

    def _loop_stats(self) -> dict:
        stats = self._busy.snapshot()
        stats.update(plans_applied=self.plans_applied, plans_processed=self.plans_processed,
                     nodes_repartitioned=self.nodes_repartitioned,
                     capacity_freed_fires=self.capacity_freed_fires)
        return stats

    def _batch_loop(self) -> None:
        PROFILER.register_thread()
        try:
            self._batch_loop_inner()
        finally:
            PROFILER.unregister_thread()

    def _batch_loop_inner(self) -> None:
        beat = f"partitioner-{self.kind}"
        while not self._stop.is_set():
            t0 = time.monotonic()
            batch = self.batcher.wait(timeout=0.2)
            WATCHDOG.beat(beat)
            if batch is None:
                self._busy.record(0.0, idle_s=time.monotonic() - t0)
                continue
            with self._lock:
                self._batched.clear()
            # a released batch waits for every node to acknowledge its plan
            while not self.gate_open():
                if self._stop.wait(0.02):
                    return
            t1 = time.monotonic()
            try:
                with self._lock:
                    self.process_pending_pods()
                    self._enqueue()  # level-triggered: the pods still pending
            except Exception:  # the loop goes on
                log.exception("partitioner %s: batch processing failed", self.kind)
            finally:
                self._busy.record(time.monotonic() - t1, idle_s=t1 - t0)

    # ------------------------------------------------------ processing

    def fetch_pending_pods(self) -> List[Pod]:
        """Every pending unbound pod (reference :202-210), as the store
        holds it: planning only reads pods."""
        name = self.scheduler_name
        return [p for p in self.store.list("Pod", copy=False)
                if p.phase == PodPhase.PENDING and not p.node
                and (not name or p.scheduler_name == name)]

    def process_pending_pods(self) -> int:
        """Snapshot, plan, actuate; the nodes re-partitioned (0: a no-op
        plan). The pending pods, the watermark, the snapshot and the plan
        are taken under one hold of the store (``NodeStore.hold``), so the
        plan read the store at its watermark, the state replay re-plans
        on; the snapshot reads the store (a rebuild through
        ``StoreState``), not the watch-fed state, which may lag it. The
        actuation, the records, the ledger, the events and a sampled
        audit come after the hold."""
        with ExitStack() as held:
            held.enter_context(self.store.hold())
            pending = self.fetch_pending_pods()
            if not pending:
                return 0
            # the watermark: replay applies the deltas up to here, then plans
            revision = self.store.revision
            with TRACER.span("partitioner.process", kind=self.kind,
                             pending=len(pending)) as proc:
                applied, plan = self._plan_and_apply(pending, revision, proc, held)
        self.plans_processed += 1
        self.last_applied = applied
        if applied:
            self.plans_applied += 1
            self.nodes_repartitioned += applied
            metrics.PLANS_APPLIED.inc()
            log.info("partitioner %s: plan %s applied to %d nodes for %d pending pods",
                     self.kind, plan.id, applied, len(pending))
        self._record_plan_events(pending, applied)
        return applied

    def _plan_and_apply(self, pending: List[Pod], revision: int, proc,
                        held: ExitStack) -> Tuple[int, PartitioningPlan]:
        """The cycle inside its span; ``held`` is released once the plan
        has read what it reads."""
        trace_id = proc.trace_id
        state = StoreState(self.store)
        shard = None
        audit_runs = None
        with TRACER.span("snapshot.take"):
            if self.pool_sharding:
                shard = self._shard_snapshot(state, pending)
                snapshot = shard[0]
            elif self.incremental_planning:
                snapshot, dirty = self._maintain_snapshot(state)
            else:
                snapshot = self.snapshot_taker.take_snapshot(state)
                dirty = None
        record: dict = {}
        if shard is not None:
            current, desired, record, audit_runs = self._plan_sharded(pending, shard)
        else:
            current = snapshot.partitioning_state()
            desired = self.planner.plan(snapshot, pending, dirty=dirty)
            self.last_unserved = dict(self.planner.last_unserved)
            self.last_pending_ages = dict(self.planner.last_pending_ages)
            self.last_plan_mode = self.planner.last_plan_mode
        held.close()  # the plan has read the store: the rest writes or re-reads it
        plan = PartitioningPlan(desired_state=desired, id=self.plan_id_fn())
        proc.set_attributes(plan_id=plan.id)
        with TRACER.span("partitioner.actuate", plan_id=plan.id):
            applied = self.actuator.apply(current, plan)
        proc.set_attributes(nodes_repartitioned=applied)
        self._record_plan(pending, plan, applied, record)
        self._record_flight(revision, pending, plan, applied, trace_id)
        if self.capacity_ledger is not None:
            # close the interval since the last observation and label
            # the pending idle time with this plan's reasons
            self.capacity_ledger.observe(self.clock(), unserved=dict(self.last_unserved),
                                         trace_id=trace_id)
        if self.forecaster is not None:
            self.forecaster.notify_cycle(pending, now=self.clock())
        if self.auditor is not None and self.auditor.should_audit():
            if audit_runs is not None:
                violations = self.auditor.audit_sharded_plan(
                    audit_runs, snapshot=snapshot, revision=revision,
                    ledger=self.capacity_ledger)
            else:
                violations = self.auditor.audit_plan(
                    self.planner, snapshot, revision=revision, pending=pending,
                    desired=desired, ledger=self.capacity_ledger)
            proc.set_attributes(audit_violations=len(violations))
        self._save_warm_state(snapshot, shard)
        return applied, plan

    def _maintain_snapshot(self, cluster_state: ClusterState):
        if self.maintainer is None:
            self.maintainer = IncrementalSnapshotMaintainer(self.store, self.snapshot_taker,
                                                            self.kind)
        snapshot, dirty = self.maintainer.snapshot(cluster_state)
        if self._warm_codec is not None and snapshot is not self._last_base:
            # a new base: adopt the saved memos of every node whose state
            # still matches, plan the others as dirty
            report = self._warm_codec.adopt(snapshot, self.planner)
            dirty = set(report.unmatched)
            self._publish_warm_boot(report)
        self._last_base = snapshot
        return snapshot, dirty

    def close(self) -> None:
        """Stop the pool workers."""
        if self._worker_pool is not None:
            self._worker_pool.close()
            self._worker_pool = None

    # ------------------------------------------------------ pool sharding

    def _shard_snapshot(self, cluster_state: ClusterState, pending: List[Pod]):
        if self.shard_maintainer is None:
            self.shard_maintainer = PoolShardedMaintainer(self.store, self.snapshot_taker,
                                                          self.kind)
        return self.shard_maintainer.shard(cluster_state, pending)

    def _new_planner(self) -> Planner:
        """A pool planner: the controller planner's framework and knobs,
        memos of its own."""
        t = self.planner
        planner = Planner(t.framework, verdict_cache_enabled=t.verdict_cache_enabled,
                          clock=t.clock, futility_memo_enabled=t.futility_memo_enabled,
                          incremental_dirty_threshold=t.incremental_dirty_threshold)
        planner.aging_per_second = t.aging_per_second
        return planner

    def _new_pool_planners(self, snapshot, partition, pool_snaps, pool_dirty) -> None:
        """After a pool rebuild: a planner a pool, each taking the old
        planners' first sightings (pods keep their ages) and the saved
        warm state of its nodes (their pool's dirty set shrinks to the
        unmatched)."""
        old = list(self._pool_planners.values()) or [self.planner]
        self._pool_planners = {}
        doc = (self._warm_codec.load(type(snapshot.codec).__name__)
               if self._warm_codec is not None else None)
        total = AdoptReport(unmatched=set() if doc is not None else set(snapshot.get_nodes()))
        for pool in partition.pools:
            planner = self._new_planner()
            for prior in old:
                planner.adopt_pending_seen(prior)
            if doc is not None:
                report = self._warm_codec.adopt(pool_snaps[pool], planner, doc)
                pool_dirty[pool] = set(report.unmatched)
                total.matched += report.matched
                total.unmatched |= report.unmatched
                total.adopted_entries += report.adopted_entries
            self._pool_planners[pool] = planner
        if self._warm_codec is not None:
            self._publish_warm_boot(total)

    def _plan_sharded(self, pending: List[Pod], shard) -> Tuple[PartitioningState,
                                                                  PartitioningState, dict,
                                                                  list]:
        """(current, desired, the plan record's sharding fields, the
        auditor's pool runs): each pool planned, the merge checked; a
        failed check gives desired = current and rebuilds the pools next
        plan. A pool planned on its worker process is audited behind its
        parent-side planner, which takes the worker's mode, ages and
        reasons (the reference's proxy planner, ``:904``): its cache checks
        are skipped (``memos_remote``: the memos live in the worker), and
        the shadow replan runs here."""
        snapshot, _, partition, pool_snaps, pool_dirty = shard
        maintainer = self.shard_maintainer
        self.last_partition = partition
        pool_pending = split_pending(pending, partition)
        if maintainer.last_rebuilt:
            self._new_pool_planners(snapshot, partition, pool_snaps, pool_dirty)
        metrics.PLAN_POOL_COUNT.labels(kind=self.kind).set(len(partition.pools))
        workers = self._ensure_worker_pool(snapshot) if self.pool_backend == "process" else None
        frames = {}
        if workers is not None:
            plans = workers.plan_pools(
                pool_snaps, pool_dirty, pool_pending, self._pool_planners,
                rebuilt=maintainer.last_rebuilt, now=self.store.clock(),
                quotas=self.store.list("ElasticQuota", copy=False),
                composite_quotas=self.store.list("CompositeElasticQuota", copy=False),
                external_usage=self._external_usage(partition),
                holders=self._reservation_holders(partition, pool_pending))
            frames = {"frame_bytes": workers.last_frame_bytes}
            if any(p.backend == "escalated" for p in plans.values()):
                # the next worker starts from a fresh image of rebuilt pools
                maintainer.force_rebuild()
        else:
            plans = {pool: plan_pool(self._pool_planners[pool], pool_snaps[pool],
                                     pool_pending[pool], pool_dirty[pool])
                     for pool in sorted(partition.pools)}
        self.last_unserved, self.last_pending_ages = {}, {}
        record: dict = {"backends": {}, "pool_ms": {}, "modes": {}, **frames}
        for pool, p in sorted(plans.items()):
            self._pool_planners[pool].memos_remote = p.backend == "process"
            if p.backend == "process":
                proxy = self._pool_planners[pool]
                keys = {pod.namespaced_name for pod in pool_pending[pool]}
                proxy.last_plan_mode = p.plan_mode
                proxy.last_unserved = {k: v for k, v in p.unserved.items() if k in keys}
                proxy.last_pending_ages = dict(p.pending_ages)
            elif p.backend == "escalated" and self.flight_recorder is not None:
                self.flight_recorder.record_pool_escalation(
                    kind=self.kind, pool=pool, revision=self.store.revision,
                    reason="the pool's worker did not serve the cycle")
            self.last_unserved.update(p.unserved)
            self.last_pending_ages.update(p.pending_ages)
            metrics.PLAN_POOL_DURATION.labels(pool=pool).observe(p.seconds)
            metrics.PLAN_BACKEND.labels(backend=p.backend).inc()
            record["backends"][pool] = p.backend
            record["pool_ms"][pool] = p.seconds * 1e3
            record["modes"][pool] = p.plan_mode
        modes = set(record["modes"].values())
        self.last_plan_mode = modes.pop() if len(modes) == 1 else "mixed"
        t0 = time.perf_counter()
        pool_current = {pool: p.current for pool, p in plans.items()}
        pool_desired = {pool: p.desired for pool, p in plans.items()}
        audit_runs = [(pool, self._pool_planners[pool], pool_snaps[pool], pool_pending[pool],
                       pool_desired[pool]) for pool in sorted(plans)]
        current = merge_pool_states(pool_current)
        violations = check_merge_invariants(partition, pool_current, pool_desired,
                                            capacities=node_capacities(pool_snaps.values()))
        desired = current if violations else merge_pool_states(pool_desired)
        record.update(pools=list(partition.pools), merge_ms=(time.perf_counter() - t0) * 1e3,
                      merge_violations=violations[:5])
        if violations:
            metrics.PLAN_MERGE_CONFLICTS.inc()
            maintainer.force_rebuild()
            log.error("partitioner[%s]: the sharded plan's merge checks failed; actuating "
                      "nothing and rebuilding the pools: %s", self.kind, "; ".join(violations[:5]))
        return current, desired, record, audit_runs

    # -------------------------------------------------- process backend

    def _ensure_worker_pool(self, snapshot):
        """The workers, started on first use; None (planning serially from
        then on) when ``framework_spec`` refuses the planner's framework."""
        from nos_tpu_torch.partitioning.core.procpool import (
            PoolWorkerPool,
            framework_spec,
            planner_knobs,
        )

        if self._worker_pool is not None or self._process_disabled:
            return self._worker_pool
        spec = framework_spec(self.planner.framework)
        if spec is None:
            self._process_disabled = True
            log.warning("partitioner[%s]: the framework has plugins a worker cannot build; "
                        "the process backend is off, planning serially", self.kind)
            return None
        self._worker_pool = PoolWorkerPool(
            self.kind, type(snapshot.codec).__name__, spec, planner_knobs(self.planner),
            cycle_timeout_seconds=self.pool_cycle_timeout_seconds,
            warm_state_path=self._warm_codec.path if self._warm_codec is not None else "",
            clock=self.clock)
        return self._worker_pool

    def _external_usage(self, partition) -> Dict[str, Dict[str, dict]]:
        """pool → quota → the usage of the pods bound outside the pool's
        nodes, which its worker's replica does not hold."""
        capacity = next((p for p in self.planner.framework.pre_filter_plugins
                         if isinstance(p, CapacityScheduling)), None)
        if capacity is None:
            return {}
        infos = build_quota_infos(self.store, capacity.gpu_memory_gb)
        inside: Dict[str, Dict[str, dict]] = {}
        for node, pods in self.store.pods_by_node().items():
            pool = partition.node_pool.get(node)
            for pod in pods if pool is not None else ():
                info = infos.for_namespace(pod.namespace)
                if info is not None:
                    usage = inside.setdefault(pool, {}).setdefault(info.name, {})
                    for k, v in quota_request(pod, capacity.gpu_memory_gb).items():
                        usage[k] = usage.get(k, 0) + v
        out: Dict[str, Dict[str, dict]] = {}
        for pool in partition.pools:
            mine = inside.get(pool, {})
            out[pool] = {}
            for info in infos:
                outside = {k: v for k, v in res.subtract_resources(
                    info.used, mine.get(info.name, {})).items() if v}
                if outside:
                    out[pool][info.name] = outside
        return out

    def _reservation_holders(self, partition, pool_pending) -> Dict[str, List[Pod]]:
        """pool → the pending holders of its nodes' drain reservations that
        are not among its pending pods: ``BoardReservation`` reads them."""
        out: Dict[str, Dict[str, Pod]] = {}
        for node in self.store.list("Node", copy=False):
            pool = partition.node_pool.get(node.name)
            holder = node.annotations.get(RESERVED_FOR, "")
            if pool is None or not holder:
                continue
            ns, _, name = holder.partition("/")
            pod = self.store.try_get("Pod", name, ns, copy=False)
            if pod is None or pod.node or pod.phase != PodPhase.PENDING or any(
                    p.namespaced_name == holder for p in pool_pending[pool]):
                continue
            out.setdefault(pool, {})[holder] = pod
        return {pool: list(pods.values()) for pool, pods in out.items()}

    # -------------------------------------------------------- warm state

    def _publish_warm_boot(self, report: AdoptReport) -> None:
        outcome = report.outcome()
        metrics.WARM_BOOT_OUTCOME.labels(outcome=outcome).inc()
        self.last_warm_boot = {"outcome": outcome, "matched": report.matched,
                               "unmatched": len(report.unmatched),
                               "adopted_entries": report.adopted_entries}
        log.info("partitioner[%s]: warm boot %s (%d nodes matched, %d dirty, %d entries)",
                 self.kind, outcome, report.matched, len(report.unmatched),
                 report.adopted_entries)

    def _save_warm_state(self, snapshot, shard) -> None:
        codec = self._warm_codec
        if codec is None:
            return
        if shard is None:
            codec.save(snapshot, self.planner)
            return
        if not codec.due():
            return
        pool_snaps = shard[3]
        if self._worker_pool is not None:
            entries, signatures = self._worker_pool.export_warm_state()
            if signatures:
                codec.save_entries(snapshot, entries, signatures=signatures)
            return
        entries, signing = {}, {}
        for pool, planner in self._pool_planners.items():
            if pool in pool_snaps:
                entries.update(planner.export_warm_state(pool_snaps[pool]))
                signing.update(pool_snaps[pool].get_nodes())
        codec.save_entries(snapshot, entries, nodes=signing)

    def _record_plan(self, pending: List[Pod], plan: PartitioningPlan, applied: int,
                     sharding: dict) -> None:
        """The plan's record (the reference writes it to its flight
        recorder): pending pods, plan id, desired state, unserved pods,
        and when sharded the pools, their backends and times."""
        self.plans.append({
            "kind": self.kind,
            "pending": [p.namespaced_name for p in pending],
            "pending_ages": dict(self.last_pending_ages),
            "plan_id": plan.id,
            "desired": partitioning_state_to_dict(plan.desired_state),
            "unserved": dict(self.last_unserved),
            "mode": self.last_plan_mode,
            "applied": applied,
            **sharding,
        })

    def _record_flight(self, revision: int, pending: List[Pod], plan: PartitioningPlan,
                       applied: int, trace_id: str) -> None:
        """The plan's ``planner.plan`` record (its watermark, pending pods
        and ages, desired state, reasons) and its ``actuation`` record
        (the revision after the actuation's writes)."""
        if self.flight_recorder is None:
            return
        self.flight_recorder.record_plan(
            kind=self.kind, revision=revision, pending=[p.namespaced_name for p in pending],
            pending_ages=dict(self.last_pending_ages), plan_id=plan.id,
            desired=partitioning_state_to_dict(plan.desired_state),
            unserved=dict(self.last_unserved), applied=applied, trace_id=trace_id)
        self.flight_recorder.record_actuation(kind=self.kind, plan_id=plan.id,
                                              revision=self.store.revision, applied=applied)

    def _record_plan_events(self, pending: List[Pod], applied: int) -> None:
        """``CarveFailed`` for a pod the plan could not serve, once a
        reason (a plan loop re-deriving one verdict records nothing new),
        and ``PartitioningApplied`` for a served pod of a plan that
        re-partitioned; no message names the plan id, which changes every
        plan and would defeat the events' dedup (``:1050-1090``)."""
        if self.recorder is None:
            return
        from nos_tpu_torch.api.v1alpha1.constants import (
            EVENT_REASON_CARVE_FAILED,
            EVENT_REASON_PARTITIONING_APPLIED,
        )

        live = {p.namespaced_name for p in pending}
        self._last_carve_reason = {k: v for k, v in self._last_carve_reason.items()
                                   if k in live}
        for pod in pending:
            key = pod.namespaced_name
            reason = self.last_unserved.get(key)
            if reason is not None:
                if self._last_carve_reason.get(key) == reason:
                    continue
                self._last_carve_reason[key] = reason
                self.recorder.record(pod, EVENT_REASON_CARVE_FAILED,
                                     f"cannot carve slices for {key}: {reason}", type="Warning")
            else:
                self._last_carve_reason.pop(key, None)
                if applied:
                    self.recorder.record(pod, EVENT_REASON_PARTITIONING_APPLIED,
                                         f"re-partitioned {applied} node(s) to serve {key}")
