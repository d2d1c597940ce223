"""Pool planning in worker processes: one long-lived worker a pool.

Counterpart of ``nos_tpu/partitioning/core/procpool.py``: the wire docs
(``snapshot_node_to_wire`` / ``_from_wire``, ``quotas_to_wire`` /
``_from_wire``), ``framework_spec`` / ``build_framework_from_spec``,
``planner_knobs``, ``PendingSeenLedger``, ``pool_worker_main`` with its
``_WorkerState`` (bootstrap, cycle, export), ``WorkerUnavailable`` and
``PoolWorkerPool`` (``sync_pools``, ``bootstrap``, ``plan_cycle``,
``export_warm``, ``close``). Each worker is an event-driven loop of the
timeline's watchdog (``poolworker.<pool>``, its replies the counter),
registered while it lives (``:578-595``). Left out: ``chaos_kill_one``
(``:739-750``), item 18b.3; the tests kill a worker's process themselves
(``pids()``).

The planner is pure Python, so threads give it no parallel work; a
worker process a pool does. Each worker holds its pool's replica store,
base snapshot and planner, with their memos, across cycles, and a cycle
ships only the nodes that changed. The protocol speaks
``snapcodec.py``'s frames (a header, then one JSON document) over a
pipe; nothing is pickled:

- ``bootstrap``: the pool's whole wire image (each snapshot node's store
  node and bound pods, and F4's refusals of a MIG node), the quotas, the
  planner's knobs, the framework's spec and the known-geometry overrides,
  at spawn and after every pool rebuild. The worker rebuilds each node
  through its taker's ``take_snapshot_node``, the parent's constructor,
  after ``take_in_refusals`` has given its taker the parent's refusals of
  that node: the port's MIG taker is stateful (F4), and without them the
  worker could plan a geometry the node's agent refused. With a warm-state
  path it adopts the saved memos.
- ``cycle``: the refreshed nodes' wire entries; the pool's pending pods
  as keys in the parent's order with the docs of only those new or
  changed since the worker's last cycle (a pod the store holds is never
  changed in place, so the same object is the same doc), and their ages
  from the parent's ``PendingSeenLedger``; each quota's usage by pods
  outside the pool (``CapacityScheduling.set_external_usage``: the
  replica holds only its pool's pods); the pending holders of the pool's
  drain reservations; and the store's clock. The reply names the nodes
  the plan touched with their GPUs' slices, the unserved reasons that
  changed since its last reply and the pods no longer unserved, the ages
  and the plan mode.
- ``export``: the planner's warm-state entries with the worker's own
  signatures of its nodes, for the parent's rate-limited save.

``PoolWorkerPool.plan_pools`` is the whole protocol on the parent's
side: it bootstraps after a pool rebuild, builds every request, keeps a
mirror of each worker's base (its bootstrap image, the refreshed nodes
and the touched nodes of its replies) to rebuild the pool's desired
state, and hands back one ``pools.PoolPlan`` a pool. A timeout, an end of
file or a frame it cannot trust drops the worker: that pool is planned in
the parent for the cycle (the same plan, ``escalated``), the caller
rebuilds the pools, and the next cycle spawns a worker again from a fresh
image.
The reply deadline is the one wall-clock read here, a liveness timeout;
ages run on the parent's clock (``SimCluster``'s is virtual).

Start method: ``forkserver``, with this module and the planner's modules
preloaded in the server. The package's root imports ``torch`` (it sets
the card's TF32 switches), and a spawned worker would pay that import
(seconds) on every spawn and respawn for code that uses no torch; a
forked one starts from the server's loaded modules. On the card's host
a spawned worker took 8.0–8.2 s to bootstrap, a forked one 0.16–0.37 s
after the server's own start of 8.2–8.4 s (``PERF.md`` §5), which
``start_fork_server`` lets a caller begin early. ``torch`` is in a
worker's ``sys.modules`` (the ready reply says so); the worker never
touches the card.
"""
from __future__ import annotations

import logging
import multiprocessing
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Set

from nos_tpu_torch.partitioning.core.planner import PENDING_TTL_S
from nos_tpu_torch.partitioning.core.snapcodec import (
    SNAPSHOT_CODEC_VERSION,
    FrameError,
    decode_frame,
    encode_frame,
    node_refusals,
)
from nos_tpu_torch.timeline.watchdog import WATCHDOG

log = logging.getLogger("nos_tpu_torch.partitioner")

START_METHOD = "forkserver"
# what the fork server loads once, so a worker forks with it loaded
PRELOAD = ("nos_tpu_torch.partitioning.core.procpool", "nos_tpu_torch.partitioning.mig",
           "nos_tpu_torch.partitioning.mps", "nos_tpu_torch.kube.flatwire",
           "nos_tpu_torch.scheduler")


def start_fork_server() -> None:
    """Start the fork server, its modules preloaded, without waiting for
    it: a caller that will plan on workers soon overlaps the server's
    imports with its own work. Idempotent; ``PoolWorkerPool`` calls it."""
    from multiprocessing import forkserver

    multiprocessing.get_context("forkserver").set_forkserver_preload(list(PRELOAD))
    forkserver.ensure_running()


# ------------------------------------------------------------------ wire docs


def snapshot_node_to_wire(snap_node) -> dict:
    """A snapshot node's store node and bound pods, and its GPUs'
    refusals: what the worker's taker rebuilds it from."""
    from nos_tpu_torch.kube.flatwire import node_to_wire, pod_to_wire

    return {"node": node_to_wire(snap_node.node),
            "pods": [pod_to_wire(pod) for pod in snap_node.pods],
            "refused": {str(i): g for i, g in node_refusals(snap_node).items()}}


def snapshot_node_from_wire(entry: dict, taker):
    """(node, pods, snapshot node) through ``taker``, given the refusals
    first."""
    from nos_tpu_torch.kube.flatwire import node_from_wire, pod_from_wire

    node = node_from_wire(entry["node"])
    pods = [pod_from_wire(doc) for doc in entry["pods"]]
    if hasattr(taker, "take_in_refusals"):
        taker.take_in_refusals(node, {int(i): g for i, g in entry.get("refused", {}).items()})
    return node, pods, taker.take_snapshot_node(node, pods)


def quotas_to_wire(quotas, composite_quotas) -> List[dict]:
    from nos_tpu_torch.kube.flatwire import ceq_to_wire, eq_to_wire

    return ([{"kind": "ElasticQuota", "doc": eq_to_wire(q)} for q in quotas]
            + [{"kind": "CompositeElasticQuota", "doc": ceq_to_wire(q)}
               for q in composite_quotas])


def quotas_from_wire(entries: List[dict]) -> list:
    from nos_tpu_torch.kube.flatwire import ceq_from_wire, eq_from_wire

    return [eq_from_wire(e["doc"]) if e["kind"] == "ElasticQuota" else ceq_from_wire(e["doc"])
            for e in entries]


# ------------------------------------------------------------ framework spec
#
# A worker cannot receive a live framework (its plugins read the parent's
# store), so the parent sends the plugin names of each chain and the
# worker builds the same plugins over its replica store. A plugin outside
# this registry makes ``framework_spec`` return None: the controller then
# plans on threads or serially rather than with another policy.

_PURE_PLUGINS = ("NodeResourcesFit", "NodeSelectorFit", "NodeAffinityFit", "TaintTolerationFit",
                 "NodeUnschedulableFit", "PodTopologySpreadFit", "InterPodAffinityFit")
_STORE_PLUGINS = ("CapacityScheduling", "MultinodeFilter", "BoardReservation")


def framework_spec(framework) -> Optional[dict]:
    """The framework as plugin names (and the store plugins' knobs), or
    None when it cannot be rebuilt in a worker."""
    if framework.post_filter_plugins or framework.reserve_plugins or framework.permit_plugins:
        return None
    spec: dict = {"pre_filter": [], "filter": []}
    for chain, plugins in (("pre_filter", framework.pre_filter_plugins),
                           ("filter", framework.filter_plugins)):
        for plugin in plugins:
            name = type(plugin).__name__
            if name not in _PURE_PLUGINS + _STORE_PLUGINS:
                return None
            if name == "MultinodeFilter" and plugin.gang is not None:
                return None  # the scheduler's Permit state lives in the parent
            spec[chain].append(name)
            if name == "CapacityScheduling":
                spec["gpu_memory_gb"] = plugin.gpu_memory_gb
            elif name == "BoardReservation":
                spec["reservation"] = [plugin.ttl, plugin.min_wait]
    return spec


def build_framework_from_spec(spec: dict, store):
    from nos_tpu_torch.scheduler import framework as fw
    from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
    from nos_tpu_torch.scheduler.plugins.reservation import BoardReservation
    from nos_tpu_torch.scheduler.plugins.topology import MultinodeFilter

    def build(name: str):
        if name == "CapacityScheduling":
            return CapacityScheduling(store, spec.get("gpu_memory_gb"))
        if name == "MultinodeFilter":
            return MultinodeFilter(store)
        if name == "BoardReservation":
            ttl, min_wait = spec["reservation"]
            return BoardReservation(store, ttl_seconds=ttl, min_wait_seconds=min_wait)
        return getattr(fw, name)()

    return fw.Framework(pre_filter_plugins=[build(n) for n in spec["pre_filter"]],
                        filter_plugins=[build(n) for n in spec["filter"]])


def planner_knobs(planner) -> dict:
    return {"verdict_cache_enabled": planner.verdict_cache_enabled,
            "futility_memo_enabled": planner.futility_memo_enabled,
            "incremental_dirty_threshold": planner.incremental_dirty_threshold}


def _slice_codec(name: str):
    from nos_tpu_torch.partitioning.core.codec import MigSliceCodec, MpsSliceCodec

    return {"MigSliceCodec": MigSliceCodec, "MpsSliceCodec": MpsSliceCodec}[name]()


def _taker(kind: str):
    from nos_tpu_torch.gpu.node import PARTITIONING_MPS

    if kind == PARTITIONING_MPS:
        from nos_tpu_torch.partitioning.mps import MpsSnapshotTaker

        return MpsSnapshotTaker()
    from nos_tpu_torch.partitioning.mig import MigSnapshotTaker

    return MigSnapshotTaker()


# ------------------------------------------------------------- pending ages


class PendingSeenLedger:
    """The parent's first sightings of pending pods, the planner's own
    bookkeeping (keyed by name and uid, forgotten ``PENDING_TTL_S``
    unseen) on the parent's clock: workers in separate processes, and
    respawned ones, would each start their own, so the parent sends the
    ages."""

    def __init__(self, clock: Callable[[], float]) -> None:
        self.clock = clock
        self._seen: Dict[tuple, tuple] = {}

    def ages(self, pods, now: Optional[float] = None) -> Dict[str, float]:
        now = self.clock() if now is None else now
        live = {(p.namespaced_name, p.uid) for p in pods}
        for key in live:
            first, _ = self._seen.get(key, (now, now))
            self._seen[key] = (first, now)
        self._seen = {k: v for k, v in self._seen.items() if now - v[1] <= PENDING_TTL_S}
        return {k[0]: now - v[0] for k, v in self._seen.items() if k in live}


# ------------------------------------------------------------ worker process


def pool_worker_main(conn, pool: str, kind: str) -> None:
    """A worker's entry point: serve bootstrap / cycle / export frames
    until ``stop`` or the pipe closes. An exception is replied as
    an ``error``, which the parent treats as a dead worker."""
    state = _WorkerState(pool, kind)
    while True:
        try:
            request = decode_frame(conn.recv_bytes())
        except (EOFError, OSError):
            return
        except FrameError as exc:
            # an untrusted frame: our state may no longer be the parent's
            try:
                conn.send_bytes(encode_frame({"op": "error", "detail": str(exc)}))
            except (OSError, ValueError):
                pass
            return
        if request.get("op") == "stop":
            return
        try:
            reply = state.dispatch(request)
        except Exception as exc:  # noqa: BLE001 - reported to the parent
            reply = {"op": "error", "seq": request.get("seq"),
                     "detail": f"{type(exc).__name__}: {exc}"}
        try:
            conn.send_bytes(encode_frame(reply))
        except (OSError, ValueError):
            return


class _WorkerState:
    """What a worker owns for its pool."""

    def __init__(self, pool: str, kind: str) -> None:
        self.pool = pool
        self.kind = kind
        self.now = 0.0  # the parent's clock, as the last request gave it
        self.store = None
        self.base = None
        self.planner = None
        self.taker = None
        self.capacity = None
        self.codec = None
        self.bootstrap_dirty: Set[str] = set()
        # node → the keys of its bound pods; the pending and context keys
        self._node_pods: Dict[str, Set[str]] = {}
        self._loose: Set[str] = set()
        # the pool's pending pods as the parent last sent them, and the
        # unserved reasons as last replied
        self._pending: Dict[str, object] = {}
        self._unserved: Dict[str, str] = {}

    def dispatch(self, request: dict) -> dict:
        op = request["op"]
        if op == "bootstrap":
            return self.bootstrap(request)
        if op == "cycle":
            return self.cycle(request)
        if op == "export":
            return self.export(request)
        return {"op": "error", "seq": request.get("seq"), "detail": f"unknown op {op!r}"}

    def bootstrap(self, request: dict) -> dict:
        from nos_tpu_torch.gpu.known import set_known_geometries
        from nos_tpu_torch.kube.store import NodeStore
        from nos_tpu_torch.partitioning.core.planner import Planner
        from nos_tpu_torch.partitioning.core.snapcodec import WarmStateCodec
        from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot

        seq = request.get("seq")
        if request.get("codec_version") != SNAPSHOT_CODEC_VERSION:
            return {"op": "reject", "seq": seq,
                    "detail": f"codec version {request.get('codec_version')!r} != "
                              f"{SNAPSHOT_CODEC_VERSION}"}
        # module-level overrides do not cross the process boundary
        set_known_geometries(request.get("geometry_overrides") or None)
        self.now = request.get("now", 0.0)
        self.store = NodeStore(clock=lambda: self.now)
        self.taker = _taker(self.kind)
        self._node_pods, self._loose, self._pending, self._unserved = {}, set(), {}, {}
        for quota in quotas_from_wire(request.get("quotas", [])):
            self.store.apply(quota)
        nodes = {}
        for entry in request["nodes"]:
            node, pods, snap_node = snapshot_node_from_wire(entry, self.taker)
            if snap_node is None:
                return {"op": "error", "seq": seq,
                        "detail": f"node {node.name} out of the taker's scope"}
            self._apply_node(node, pods)
            nodes[node.name] = snap_node
        self.base = ClusterSnapshot(nodes, codec=_slice_codec(request["slice_codec"]))
        framework = build_framework_from_spec(request["framework"], self.store)
        self.capacity = next((p for p in framework.pre_filter_plugins
                              if type(p).__name__ == "CapacityScheduling"), None)
        self.planner = Planner(framework, **request["knobs"])
        self.bootstrap_dirty = set(nodes)
        self.codec = WarmStateCodec(request.get("warm_state_path") or "")
        adopted = 0
        if request.get("warm_state_path"):
            report = self.codec.adopt(self.base, self.planner)
            self.bootstrap_dirty = set(report.unmatched)
            adopted = report.adopted_entries
        return {"op": "ready", "seq": seq, "pool": self.pool, "nodes": len(nodes),
                "adopted_entries": adopted, "pid": os.getpid(),
                "torch_loaded": "torch" in sys.modules}

    def _apply_node(self, node, pods) -> None:
        # the objects are this worker's own, just decoded: stored uncopied
        self.store.apply(node, copy=False)
        for pod in pods:
            self.store.apply(pod, copy=False)
        self._node_pods[node.name] = {pod.namespaced_name for pod in pods}

    def _retract(self) -> None:
        """Delete the replica's pods no node, pending list or context
        names any more (finished, deleted, or moved out of the pool)."""
        wanted = set(self._loose).union(*self._node_pods.values())
        for pod in self.store.list("Pod", copy=False):
            if pod.namespaced_name not in wanted:
                self.store.delete("Pod", pod.name, pod.namespace)

    def cycle(self, request: dict) -> dict:
        from nos_tpu_torch.kube.flatwire import pod_from_wire

        seq = request.get("seq")
        if self.base is None:
            return {"op": "error", "seq": seq, "detail": "cycle before bootstrap"}
        self.now = request.get("now", self.now)
        dirty = set(self.bootstrap_dirty)
        self.bootstrap_dirty = set()
        for entry in request.get("deltas", []):
            node, pods, snap_node = snapshot_node_from_wire(entry, self.taker)
            if snap_node is None:
                return {"op": "error", "seq": seq,
                        "detail": f"delta {node.name} out of the taker's scope"}
            self._apply_node(node, pods)
            self.base.refresh_node(node.name, snap_node)
            dirty.add(node.name)
        docs = request.get("pending_docs", {})
        pending_now = {}
        for key in request.get("pending", []):
            if key in docs:
                pod = pod_from_wire(docs[key])
                self.store.apply(pod, copy=False)
            else:
                pod = self._pending.get(key)
                if pod is None:
                    return {"op": "error", "seq": seq, "detail": f"pending pod {key} never sent"}
            pending_now[key] = pod
        self._pending = pending_now
        pending = list(pending_now.values())
        context = [pod_from_wire(doc) for doc in request.get("context", [])]
        for pod in context:
            self.store.apply(pod, copy=False)
        self._loose = set(pending_now).union(pod.namespaced_name for pod in context)
        self._retract()
        if self.capacity is not None:
            self.capacity.set_external_usage(request.get("external_usage", {}))
        current = self.base.partitioning_state()
        t0 = time.perf_counter()
        desired = self.planner.plan(self.base, pending, dirty=dirty,
                                    pending_ages=dict(zip(pending_now, request.get("ages", []))))
        duration = time.perf_counter() - t0
        # partitioning_state() memoizes per node version: an untouched
        # node's desired entry is its pre-plan entry itself
        touched = {name: {str(g.gpu_index): dict(g.resources) for g in np.gpus}
                   for name, np in desired.items() if np is not current.get(name)}
        unserved, last = self.planner.last_unserved, self._unserved
        self._unserved = dict(unserved)
        return {"op": "plan", "seq": seq, "pool": self.pool, "touched": touched,
                "unserved": {k: v for k, v in unserved.items() if last.get(k) != v},
                "served": [k for k in last if k not in unserved],
                "pending_ages": dict(self.planner.last_pending_ages),
                "plan_mode": self.planner.last_plan_mode, "duration": duration}

    def export(self, request: dict) -> dict:
        if self.planner is None:
            return {"op": "entries", "seq": request.get("seq"), "entries": {},
                    "signatures": {}}
        return {"op": "entries", "seq": request.get("seq"), "pool": self.pool,
                "entries": self.planner.export_warm_state(self.base),
                "signatures": {name: self.codec.signature(name, n)
                               for name, n in self.base.get_nodes().items()}}


# ------------------------------------------------------------ parent's side


class WorkerUnavailable(RuntimeError):
    """A worker that cannot serve this cycle (dead, past the deadline, or
    speaking a frame not to be trusted), with the reason."""

    def __init__(self, pool: str, reason: str) -> None:
        super().__init__(f"pool {pool}: {reason}")
        self.pool = pool
        self.reason = reason


class _Worker:
    """One worker process, the parent's end of its pipe, and what the
    parent knows of the worker's state: the mirror of its base and the
    pending pods it holds."""

    def __init__(self, ctx, pool: str, kind: str) -> None:
        self.pool = pool
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self.conn = parent_conn
        self.process = ctx.Process(target=pool_worker_main, args=(child_conn, pool, kind),
                                   name=f"poolworker-{pool}", daemon=True)
        self.started = time.perf_counter()
        self.process.start()
        child_conn.close()
        self.bootstrapped = False
        self.ready_seconds: Optional[float] = None  # start to first ready reply
        self.torch_loaded: Optional[bool] = None
        self.bytes = 0  # frame bytes both ways
        self.replies = 0  # the watchdog's counter of the worker
        # node → its partitioning in the worker's base, as last planned
        self.mirror: Optional[Dict[str, object]] = None
        # pending key → (the pod object, its doc) as last sent; the
        # unserved reasons as the worker's replies left them
        self.sent: Dict[str, tuple] = {}
        self.unserved: Dict[str, str] = {}

    def send(self, doc: dict) -> None:
        data = encode_frame(doc)
        self.bytes += len(data)
        self.conn.send_bytes(data)

    def recv(self, timeout: float) -> dict:
        if not self.conn.poll(timeout):
            raise TimeoutError(f"no reply within {timeout:.1f}s")
        data = self.conn.recv_bytes()
        self.bytes += len(data)
        return decode_frame(data)

    def pending_request(self, pods, ages: Dict[str, float]) -> dict:
        """The cycle's pending fields: every key in order with its age,
        and the docs of the pods the worker does not hold as they are."""
        from nos_tpu_torch.kube.flatwire import pod_to_wire

        docs: Dict[str, dict] = {}
        sent: Dict[str, tuple] = {}
        for pod in pods:
            key = pod.namespaced_name
            last = self.sent.get(key)
            if last is None or last[0] is not pod:
                doc = pod_to_wire(pod)
                if last is None or last[1] != doc:
                    docs[key] = doc
                last = (pod, doc)
            sent[key] = last
        self.sent = sent
        return {"pending": list(sent), "pending_docs": docs,
                "ages": [ages[key] for key in sent]}

    def kill(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        if self.process.is_alive():
            self.process.terminate()
        self.process.join(timeout=2.0)


_TRANSPORT_ERRORS = (OSError, EOFError, TimeoutError, FrameError, ValueError)


class PoolWorkerPool:
    """The parent's side: a worker a pool, bootstrapped on every pool
    rebuild, one ``plan_pools`` a plan with every request sent before any
    reply is read (the workers plan at once) under one deadline. Pending
    ages come from a ``PendingSeenLedger`` on ``clock``."""

    def __init__(self, kind: str, slice_codec_name: str, spec: dict, knobs: dict,
                 cycle_timeout_seconds: float = 5.0, bootstrap_timeout_seconds: float = 60.0,
                 warm_state_path: str = "", start_method: str = START_METHOD,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.kind = kind
        self.slice_codec_name = slice_codec_name
        self.spec = spec
        self.knobs = knobs
        self.cycle_timeout = cycle_timeout_seconds
        self.bootstrap_timeout = bootstrap_timeout_seconds
        self.warm_state_path = warm_state_path
        self.ledger = PendingSeenLedger(clock)
        self._ctx = multiprocessing.get_context(start_method)
        if start_method == "forkserver":
            start_fork_server()
        self._workers: Dict[str, _Worker] = {}
        self._seq = 0
        self.restarts = 0
        self.spawned = 0
        # (ready seconds, torch loaded) of every worker that bootstrapped
        self.ready: List[tuple] = []
        self.last_frame_bytes = 0  # both ways, in the last plan_pools
        self._dropped_bytes = 0  # the frame bytes of the workers dropped

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _drop(self, pool: str, reason: str) -> None:
        worker = self._workers.pop(pool, None)
        if worker is not None:
            worker.kill()
            self._dropped_bytes += worker.bytes
        WATCHDOG.unregister(f"poolworker.{pool}")
        self.restarts += 1
        log.warning("procpool[%s]: dropping the worker of pool %s: %s", self.kind, pool, reason)

    def _spawn(self, pool: str) -> None:
        worker = self._workers[pool] = _Worker(self._ctx, pool, self.kind)
        self.spawned += 1
        WATCHDOG.register(f"poolworker.{pool}", periodic=False,
                          counter_fn=lambda: worker.replies)

    def pools(self) -> Set[str]:
        return set(self._workers)

    def pids(self) -> Dict[str, int]:
        return {pool: w.process.pid for pool, w in self._workers.items()}

    def frame_bytes(self) -> int:
        """Frame bytes both ways over the pool's life."""
        return self._dropped_bytes + sum(w.bytes for w in self._workers.values())

    def sync_pools(self, pools) -> None:
        """Spawn a worker for each new pool, stop those of pools gone."""
        wanted = set(pools)
        for pool in sorted(set(self._workers) - wanted):
            self._drop(pool, "the pool is gone")
        for pool in sorted(wanted - set(self._workers)):
            self._spawn(pool)

    def bootstrap(self, pool: str, entries: List[dict], quotas: List[dict],
                  now: float = 0.0) -> None:
        """Send a pool's whole wire image; WorkerUnavailable on a refusal
        or a timeout (the caller escalates and retries next cycle)."""
        from nos_tpu_torch.gpu.known import known_geometry_overrides

        if pool not in self._workers:
            self._spawn(pool)
        worker = self._workers[pool]
        seq = self._next_seq()
        doc = {"op": "bootstrap", "seq": seq, "codec_version": SNAPSHOT_CODEC_VERSION,
               "geometry_overrides": known_geometry_overrides(), "pool": pool,
               "slice_codec": self.slice_codec_name, "framework": self.spec,
               "knobs": self.knobs, "nodes": entries, "quotas": quotas, "now": now,
               "warm_state_path": self.warm_state_path}
        worker.mirror, worker.sent, worker.unserved = None, {}, {}
        try:
            worker.send(doc)
            reply = worker.recv(self.bootstrap_timeout)
        except _TRANSPORT_ERRORS as exc:
            self._drop(pool, f"bootstrap failed: {exc}")
            raise WorkerUnavailable(pool, f"bootstrap failed: {exc}") from exc
        if reply.get("op") != "ready" or reply.get("seq") != seq:
            detail = reply.get("detail", f"unexpected reply {reply.get('op')!r}")
            self._drop(pool, f"bootstrap refused: {detail}")
            raise WorkerUnavailable(pool, f"bootstrap refused: {detail}")
        if not worker.bootstrapped:
            worker.ready_seconds = time.perf_counter() - worker.started
            worker.torch_loaded = bool(reply.get("torch_loaded"))
            self.ready.append((worker.ready_seconds, worker.torch_loaded))
        worker.bootstrapped = True
        worker.replies += 1

    def plan_cycle(self, requests: Dict[str, dict]) -> Dict[str, object]:
        """pool → the worker's plan reply, or a WorkerUnavailable."""
        results: Dict[str, object] = {}
        sent: Dict[str, tuple] = {}
        for pool in sorted(requests):
            worker = self._workers.get(pool)
            if worker is None or not worker.bootstrapped:
                results[pool] = WorkerUnavailable(pool, "not bootstrapped")
                continue
            doc = dict(requests[pool], op="cycle", seq=self._next_seq())
            try:
                worker.send(doc)
            except (OSError, ValueError) as exc:
                self._drop(pool, f"send failed: {exc}")
                results[pool] = WorkerUnavailable(pool, f"send failed: {exc}")
                continue
            sent[pool] = (worker, doc["seq"])
        deadline = time.perf_counter() + self.cycle_timeout
        for pool, (worker, seq) in sent.items():
            try:
                reply = worker.recv(max(0.0, deadline - time.perf_counter()))
            except _TRANSPORT_ERRORS as exc:
                reason = f"{type(exc).__name__}: {exc}"
                self._drop(pool, reason)
                results[pool] = WorkerUnavailable(pool, reason)
                continue
            if reply.get("op") != "plan" or reply.get("seq") != seq:
                reason = reply.get("detail", f"unexpected reply {reply.get('op')!r}")
                self._drop(pool, reason)
                results[pool] = WorkerUnavailable(pool, reason)
                continue
            worker.replies += 1
            WATCHDOG.beat(f"poolworker.{pool}")
            results[pool] = reply
        return results

    def plan_pools(self, pool_snaps: Dict[str, object], pool_dirty: Dict[str, set],
                   pool_pending: Dict[str, list], planners: Dict[str, object], *,
                   rebuilt: bool, now: float, quotas=(), composite_quotas=(),
                   external_usage: Optional[Dict[str, dict]] = None,
                   holders: Optional[Dict[str, list]] = None) -> Dict[str, object]:
        """pool → its ``PoolPlan``, planned on the pool's worker. After a
        pool rebuild (``rebuilt``) every worker is spawned or kept and
        bootstrapped from its pool's whole image and ``quotas``; otherwise
        a worker is sent its pool's refreshed nodes (``pool_dirty``). Each
        is sent its pending pods (new and changed docs only), their ages,
        ``external_usage[pool]`` (quota → usage outside the pool) and
        ``holders[pool]`` (pending pods its drain reservations name). A
        pool whose worker fails is planned here by ``planners[pool]`` on
        the same inputs (``escalated``), and its worker dropped: the
        caller rebuilds the pools, so the next plan respawns it."""
        from nos_tpu_torch.kube.flatwire import pod_to_wire
        from nos_tpu_torch.partitioning.core.partition_state import (
            partitioning_state_from_dict,
        )
        from nos_tpu_torch.partitioning.core.pools import PoolPlan, plan_pool

        bytes_before = self.frame_bytes()
        if rebuilt:
            self.sync_pools(pool_snaps)
            wire_quotas = quotas_to_wire(quotas, composite_quotas)
            for pool in sorted(pool_snaps):
                entries = [snapshot_node_to_wire(n)
                           for _, n in sorted(pool_snaps[pool].get_nodes().items())]
                try:
                    self.bootstrap(pool, entries, wire_quotas, now=now)
                except WorkerUnavailable:
                    pass  # escalated below
        ages = self.ledger.ages([p for pool in sorted(pool_pending) for p in pool_pending[pool]])
        requests = {}
        for pool in sorted(pool_snaps):
            worker = self._workers.get(pool)
            if worker is None:
                continue  # plan_cycle reports it
            nodes = pool_snaps[pool].get_nodes()
            requests[pool] = {
                # a fresh bootstrap holds this plan's nodes already
                "deltas": [] if rebuilt else [snapshot_node_to_wire(nodes[name])
                                              for name in sorted(pool_dirty[pool])],
                **worker.pending_request(pool_pending[pool], ages),
                "external_usage": (external_usage or {}).get(pool, {}),
                "context": [pod_to_wire(p) for p in (holders or {}).get(pool, ())],
                "now": now,
            }
        replies = self.plan_cycle(requests)
        plans = {}
        for pool in sorted(pool_snaps):
            snapshot = pool_snaps[pool]
            current = snapshot.partitioning_state()
            reply = replies.get(pool, WorkerUnavailable(pool, "no worker"))
            worker = self._workers.get(pool)
            if isinstance(reply, dict) and worker is not None:
                if worker.mirror is None:
                    worker.mirror = dict(current)
                else:
                    worker.mirror.update({name: current[name] for name in pool_dirty[pool]})
                worker.mirror.update(partitioning_state_from_dict(reply["touched"]))
                for key in reply["served"]:
                    worker.unserved.pop(key, None)
                worker.unserved.update(reply["unserved"])
                plans[pool] = PoolPlan(current, dict(worker.mirror), dict(worker.unserved),
                                       reply["pending_ages"], reply["plan_mode"],
                                       reply["duration"], "process")
                continue
            log.warning("procpool[%s]: pool %s planned in the parent (%s)", self.kind, pool,
                        getattr(reply, "reason", reply))
            plans[pool] = plan_pool(planners[pool], snapshot, pool_pending[pool],
                                    pool_dirty[pool], backend="escalated",
                                    pending_ages={p.namespaced_name: ages[p.namespaced_name]
                                                  for p in pool_pending[pool]})
        self.last_frame_bytes = self.frame_bytes() - bytes_before
        return plans

    def export_warm(self, pool: str) -> Optional[tuple]:
        """(entries, signatures) of the pool's worker, or None."""
        worker = self._workers.get(pool)
        if worker is None or not worker.bootstrapped:
            return None
        try:
            worker.send({"op": "export", "seq": self._next_seq()})
            reply = worker.recv(self.cycle_timeout)
        except _TRANSPORT_ERRORS as exc:
            self._drop(pool, f"export failed: {exc}")
            return None
        if reply.get("op") != "entries":
            self._drop(pool, "export gave no entries")
            return None
        worker.replies += 1
        return reply.get("entries", {}), reply.get("signatures", {})

    def export_warm_state(self) -> tuple:
        """(entries, signatures) of every live worker, merged: the memos,
        and the node states they were derived from, are the workers'."""
        entries: Dict[str, dict] = {}
        signatures: Dict[str, str] = {}
        for pool in sorted(self._workers):
            exported = self.export_warm(pool)
            if exported is not None:
                entries.update(exported[0])
                signatures.update(exported[1])
        return entries, signatures

    def close(self) -> None:
        """Stop every worker."""
        for pool, worker in self._workers.items():
            try:
                worker.send({"op": "stop"})
            except (OSError, ValueError):
                pass
            worker.kill()
            WATCHDOG.unregister(f"poolworker.{pool}")
        self._workers = {}
