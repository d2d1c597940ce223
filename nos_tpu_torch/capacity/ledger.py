"""The capacity ledger's accounting core: GB-seconds of GPU memory.

Counterpart of ``nos_tpu/capacity/ledger.py`` (its model: ``:1-58``;
``observe`` and ``_integrate``: ``:410-545``; the deltas ``:545-667``;
the gang clocks ``:668-730``; the exports ``:732-778``; ``self_check``
and ``state_from_store``: ``:1066-1133``), in GPU memory where the
reference counts chips: a node holds its GPUs x 80 GB (its product's
memory), a bound pod its MIG instance's GB (a 3g.40gb 40) or its MPS
slice's GB, a plain ``nvidia.com/gpu`` 80 GB a GPU. Under the parity
tests' translation (one v5e chip is 10 GB) the reference's chip-seconds
x 10 are these GB-seconds.

Every ``observe(now)`` closes the interval ``[last, now)``, integrated
against the state the ledger held at its previous watermark: a write
read at this observation becomes visible at the interval's end, the
view a control cycle has. Then it reads the store's change journal
(``NodeStore.changes_since``, each change with the object its write
stored; the first observation lists the store instead, as the
reference's watch replays it), applies the changes up to the new
watermark in order, and stamps them with ``now`` (the reconfig edges).
A reader the journal has left behind rebuilds from the store. Per node,
in sorted-name order so the float sums repeat bit for bit:

- ``busy`` = the GB of the pods bound to the node, capped at its
  capacity;
- ``idle`` = capacity - busy, booked to one bucket, in this order:
  ``reconfig`` (the node's spec plan differs from its status plan),
  ``reserved-by-gang`` (the drain reservation, ``reserved-for``),
  ``autoscaler-grace`` (the autoscaler's cold-start hold), else
  ``pending-unschedulable`` up to the unbound pending demand
  (``min(idle, pending GB)`` over the cluster), labelled with the
  dominant reason of the planner's ``last_unserved``, and
  ``no-demand`` for the rest.

The sums are kept by node, by partitioning mode (``by_pool``: the
``nos.nebuly.com/gpu-partitioning`` label, as the reference keys its
pool), by namespace and by the used profiles of the nodes' status
annotations. The gang clocks (arrival, first feasible, bound) feed the
forecaster's wait ages and its accuracy join (``add_gang_bound_listener``).
The frozen edges measure the re-carve latency (``mean_reconfig_seconds``).
``self_check`` diffs the incremental state against ``state_from_store``.

Polled, with no thread: whoever drives the loop observes on its clock
(``SimCluster`` on its virtual one). Left for the observability slice
(ROADMAP.md, item 18b): the fragmentation indices, the per-node and
per-pool gauges, the heartbeat, the flight-recorder records and the
debug documents.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import RESOURCE_GPU_MEMORY
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, memory_gb_per_gpu
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, RESOURCE_GPU
from nos_tpu_torch.gpu.slicing import profile_gb
from nos_tpu_torch.kube.store import NodeStore, PodPhase
from nos_tpu_torch.scheduler.plugins.gang import gang_of
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
from nos_tpu_torch.util import metrics as m
from nos_tpu_torch.util.resources import DEFAULT_GPU_MEMORY_GB, gpu_memory_gb_in

log = logging.getLogger("nos_tpu_torch.capacity")

BUCKET_NO_DEMAND = "no-demand"
BUCKET_PENDING = "pending-unschedulable"
BUCKET_RECONFIG = "reconfig"
BUCKET_RESERVED = "reserved-by-gang"
BUCKET_AUTOSCALER = "autoscaler-grace"
IDLE_BUCKETS = (BUCKET_NO_DEMAND, BUCKET_PENDING, BUCKET_RECONFIG, BUCKET_RESERVED,
                BUCKET_AUTOSCALER)

WATCH_KINDS = ("ElasticQuota", "Node", "Pod")

# the pending label when the planner gave no reason
_REASON_QUEUED = "queued"
# completed gang waits kept
_RECENT_GANGS = 64

def _reason_prefix(reason: str) -> str:
    """A reason's low-cardinality prefix (the part before ':')."""
    return reason.split(":", 1)[0].strip() or _REASON_QUEUED


def dominant_unserved_reason(unserved: Dict[str, str]) -> Optional[str]:
    """The most common reason prefix in a pod → reason map, ties to the
    lexically first (never dict order)."""
    counts: Dict[str, int] = {}
    for reason in unserved.values():
        key = _reason_prefix(reason)
        counts[key] = counts.get(key, 0) + 1
    if not counts:
        return None
    return min(counts, key=lambda k: (-counts[k], k))


def node_gb(node: Any) -> int:
    """A node's GPU memory: its GPUs x its product's GB (80 unknown)."""
    gpus = int(node.capacity.get(RESOURCE_GPU, 0))
    return gpus * (memory_gb_per_gpu(node.labels.get(GPU_PRODUCT_LABEL, ""))
                   or DEFAULT_GPU_MEMORY_GB)


def _pod_gb(pod: Any) -> int:
    return gpu_memory_gb_in(pod.request)


def _profile_gb(profile: str) -> int:
    """A MIG profile's GB (a 3g.40gb 40) or an MPS slice's."""
    if annot.MIG_PROFILE_RE.match(profile):
        return int(profile.split(".")[1][:-2])
    return profile_gb(profile)


def _quota_gb(resource_list: Dict[str, Any]) -> int:
    """The GB a quota bound amounts to: its ``gpu-memory`` aggregate when
    it names it, else its GPU resources' GB."""
    if RESOURCE_GPU_MEMORY in resource_list:
        return int(resource_list[RESOURCE_GPU_MEMORY])
    return gpu_memory_gb_in(resource_list)


class _NodeState:
    """What the integration reads of one node, at the watermark."""

    __slots__ = ("total_gb", "pool", "product", "frozen", "reserved", "autoscaler_grace",
                 "used_profiles")

    def __init__(self, node: Any, total_gb: int) -> None:
        self.total_gb = total_gb
        self.pool = node.labels.get(PARTITIONING_LABEL, "")
        self.product = node.labels.get(GPU_PRODUCT_LABEL, "")
        ann = node.annotations
        spec_plan = ann.get(annot.SPEC_PARTITIONING_PLAN)
        self.frozen = bool(spec_plan) and spec_plan != ann.get(annot.STATUS_PARTITIONING_PLAN)
        self.reserved = RESERVED_FOR in ann
        # the autoscaler's cold-start hold: a chosen wake-latency trade,
        # not no-demand
        self.autoscaler_grace = annot.AUTOSCALER_RESERVED in ann
        _, status = annot.parse_node_annotations(ann)
        used: Dict[str, int] = {}
        for entry in status:
            if entry.status == annot.STATUS_USED:
                used[entry.profile] = (used.get(entry.profile, 0)
                                       + _profile_gb(entry.profile) * entry.quantity)
        self.used_profiles = used

    def canonical(self) -> tuple:
        return (self.total_gb, self.pool, self.product, self.frozen, self.reserved,
                self.autoscaler_grace, tuple(sorted(self.used_profiles.items())))


def _pod_entry(pod: Any):
    """("bound", (node, GB, ns)), ("pending", (GB, ns)) or None."""
    gb = _pod_gb(pod)
    if gb <= 0:
        return None
    if pod.node and pod.phase in (PodPhase.PENDING, PodPhase.RUNNING):
        return "bound", (pod.node, gb, pod.namespace)
    if pod.phase == PodPhase.PENDING:
        return "pending", (gb, pod.namespace)
    return None


def _quota_entry(quota: Any) -> Tuple[str, int, int, int]:
    return (quota.namespace, _quota_gb(quota.min), _quota_gb(quota.max), _quota_gb(quota.used))


class CapacityLedger:
    """Time-weighted GB-seconds over a ``NodeStore``; one lock guards its
    state (``observe``, the gang clocks and the readers may come from
    different threads). ``metrics`` off keeps a shadow ledger out of the
    process's registry."""

    def __init__(self, store: NodeStore, metrics: bool = True) -> None:
        self.store = store
        self._metrics = metrics
        self._lock = threading.Lock()
        self._listed = False  # the first observation lists the store
        # the state at the watermark
        self._nodes: Dict[str, _NodeState] = {}
        self._bound: Dict[str, Tuple[str, int, str]] = {}  # pod → (node, GB, ns)
        self._pending: Dict[str, Tuple[int, str]] = {}  # pod → (GB, ns)
        self._quotas: Dict[str, Tuple[str, int, int, int]] = {}  # key → (ns, min, max, used)
        self._reason: Optional[str] = None
        self._last_ts: Optional[float] = None
        self._first_ts: Optional[float] = None
        self._revision = 0
        # the integrals
        self.total_gb_seconds = 0.0
        self.busy_gb_seconds = 0.0
        self.idle_gb_seconds: Dict[str, float] = {b: 0.0 for b in IDLE_BUCKETS}
        self.pending_reason_seconds: Dict[str, float] = {}
        self.by_node: Dict[str, Dict[str, float]] = {}
        self.by_pool: Dict[str, Dict[str, float]] = {}
        self.by_namespace: Dict[str, float] = {}
        self.by_profile: Dict[str, float] = {}
        self.observes = 0
        # gang wait clocks, and the gangs' live members from the pod
        # changes: a gang whose every member goes before it binds drops its
        # clock, so a re-arrival starts a fresh one
        self._gangs: Dict[str, Dict[str, float]] = {}
        self.recent_gangs: deque = deque(maxlen=_RECENT_GANGS)
        self._gang_members: Dict[str, set] = {}
        self._pod_gang: Dict[str, str] = {}
        self._gang_bound_listeners: List[Any] = []
        # the re-carve latency: frozen edges stamped with the observation
        self._apply_now: Optional[float] = None
        self._reconfig_started: Dict[str, float] = {}
        self.reconfig_count = 0
        self.reconfig_seconds_total = 0.0

    # ------------------------------------------------------------ observe

    def observe(self, now: float, unserved: Optional[Dict[str, str]] = None) -> None:
        """Close the interval since the last observation and move the
        watermark to the store's revision. ``unserved`` (the planner's pod
        → reason map) labels the pending idle time from here to the next
        observation."""
        with self._lock:
            watermark = self.store.revision
            self._integrate(now)
            self._apply_now = now
            self._apply_changes(watermark)
            if unserved is not None:
                self._reason = dominant_unserved_reason(unserved)
            self._last_ts = now
            if self._first_ts is None:
                self._first_ts = now
            self._revision = watermark
            self.observes += 1

    def _integrate(self, now: float) -> None:
        if self._last_ts is None:
            return
        dt = now - self._last_ts
        if dt <= 0 or not self._nodes:
            return
        bound_by_node: Dict[str, int] = {}
        busy_by_ns: Dict[str, int] = {}
        for key in sorted(self._bound):
            node_name, gb, ns = self._bound[key]
            if node_name not in self._nodes:
                continue
            bound_by_node[node_name] = bound_by_node.get(node_name, 0) + gb
            busy_by_ns[ns] = busy_by_ns.get(ns, 0) + gb
        pending_gb = sum(gb for gb, _ in self._pending.values())
        available_idle = 0
        busy_total = 0
        held: Dict[str, int] = {}
        for name in sorted(self._nodes):
            st = self._nodes[name]
            busy = min(st.total_gb, bound_by_node.get(name, 0))
            idle = st.total_gb - busy
            busy_total += busy
            self.total_gb_seconds += st.total_gb * dt
            self.busy_gb_seconds += busy * dt
            node_acc = self.by_node.setdefault(name, {"total": 0.0, "busy": 0.0})
            node_acc["total"] += st.total_gb * dt
            node_acc["busy"] += busy * dt
            pool_acc = self.by_pool.setdefault(st.pool, {"total": 0.0, "busy": 0.0})
            pool_acc["total"] += st.total_gb * dt
            pool_acc["busy"] += busy * dt
            bucket = (BUCKET_RECONFIG if st.frozen else BUCKET_RESERVED if st.reserved
                      else BUCKET_AUTOSCALER if st.autoscaler_grace else None)
            if bucket is None:
                available_idle += idle
            else:
                self.idle_gb_seconds[bucket] += idle * dt
                held[bucket] = held.get(bucket, 0) + idle
            for profile in sorted(st.used_profiles):
                self.by_profile[profile] = (self.by_profile.get(profile, 0.0)
                                            + st.used_profiles[profile] * dt)
        for ns in sorted(busy_by_ns):
            self.by_namespace[ns] = self.by_namespace.get(ns, 0.0) + busy_by_ns[ns] * dt
        # idle on a node that could take pods is waste only up to the
        # pending demand that could have used it
        covered = float(min(available_idle, pending_gb))
        self.idle_gb_seconds[BUCKET_PENDING] += covered * dt
        self.idle_gb_seconds[BUCKET_NO_DEMAND] += (available_idle - covered) * dt
        if covered > 0:
            reason = self._reason or _REASON_QUEUED
            self.pending_reason_seconds[reason] = (
                self.pending_reason_seconds.get(reason, 0.0) + covered * dt)
        if self._metrics:
            c = m.CAPACITY_GB_SECONDS
            c.labels(state="busy", reason="").inc(busy_total * dt)
            for bucket in sorted(held):
                c.labels(state=bucket, reason="").inc(held[bucket] * dt)
            if covered > 0:
                c.labels(state=BUCKET_PENDING,
                         reason=self._reason or _REASON_QUEUED).inc(covered * dt)
            c.labels(state=BUCKET_NO_DEMAND, reason="").inc((available_idle - covered) * dt)

    # ------------------------------------------------------------- deltas

    def _apply_changes(self, watermark: int) -> None:
        if not self._listed:
            self._listed = True
            self._relist()
            return
        changes = self.store.changes_since(self._revision)
        if changes is None:
            log.warning("capacity ledger: the store's journal dropped writes; rebuilding")
            self._relist()
            return
        for change in changes:
            if change.revision > watermark:
                break
            if change.kind in WATCH_KINDS:
                self._apply(change.kind, change.namespace, change.name, change.obj)

    def _relist(self) -> None:
        """Every object of the watched kinds as ADDED, in (kind, namespace,
        name) order (the reference's watch replay); what is gone is
        dropped."""
        seen = {kind: set() for kind in WATCH_KINDS}
        for kind in WATCH_KINDS:
            for obj in self.store.list(kind, copy=False):
                seen[kind].add(f"{obj.namespace}/{obj.name}")
                self._apply(kind, obj.namespace, obj.name, obj)
        for name in [n for n in self._nodes if f"/{n}" not in seen["Node"]]:
            self._apply("Node", "", name, None)
        for key in [k for k in set(self._bound) | set(self._pending)
                    | set(self._pod_gang) if k not in seen["Pod"]]:
            ns, _, name = key.partition("/")
            self._apply("Pod", ns, name, None)
        for key in [k for k in self._quotas if k not in seen["ElasticQuota"]]:
            self._quotas.pop(key, None)

    def _apply(self, kind: str, namespace: str, name: str, obj: Any) -> None:
        if kind == "Node":
            self._apply_node(name, obj)
        elif kind == "Pod":
            self._apply_pod(f"{namespace}/{name}", obj)
        else:
            key = f"{namespace}/{name}"
            if obj is None:
                self._quotas.pop(key, None)
            else:
                self._quotas[key] = _quota_entry(obj)

    def _apply_node(self, name: str, node: Any) -> None:
        total = node_gb(node) if node is not None else 0
        if total <= 0:
            self._reconfig_started.pop(name, None)
            self._nodes.pop(name, None)
            return
        old = self._nodes.get(name)
        state = _NodeState(node, total)
        self._note_reconfig_edge(name, old, state)
        self._nodes[name] = state

    def _note_reconfig_edge(self, name: str, old: Optional[_NodeState],
                            new: _NodeState) -> None:
        """Frozen False → True starts a re-carve, True → False ends it."""
        was_frozen = old is not None and old.frozen
        if new.frozen and not was_frozen:
            if self._apply_now is not None:
                self._reconfig_started[name] = self._apply_now
        elif was_frozen and not new.frozen:
            started = self._reconfig_started.pop(name, None)
            if started is not None and self._apply_now is not None:
                self.reconfig_count += 1
                self.reconfig_seconds_total += max(0.0, self._apply_now - started)

    def _apply_pod(self, key: str, pod: Any) -> None:
        self._bound.pop(key, None)
        self._pending.pop(key, None)
        self._track_gang_membership(key, pod)
        if pod is None:
            return
        entry = _pod_entry(pod)
        if entry is not None:
            (self._bound if entry[0] == "bound" else self._pending)[key] = entry[1]

    def _track_gang_membership(self, key: str, pod: Any) -> None:
        """Keep the gangs' members current; drop an unbound gang's clock
        when its last member goes."""
        gang = gang_of(pod) if pod is not None else None
        gang_key = gang[0] if gang else None
        prev = self._pod_gang.get(key)
        if prev == gang_key:
            return
        if prev is not None:
            members = self._gang_members.get(prev)
            if members is not None:
                members.discard(key)
                if not members:
                    del self._gang_members[prev]
                    self._gangs.pop(prev, None)
        if gang_key is None:
            self._pod_gang.pop(key, None)
        else:
            self._pod_gang[key] = gang_key
            self._gang_members.setdefault(gang_key, set()).add(key)

    # -------------------------------------------------------- gang clocks

    def note_gang_arrival(self, gang: str, now: float) -> None:
        with self._lock:
            self._gangs.setdefault(gang, {"arrival": now})

    def note_gang_feasible(self, gang: str, now: float) -> None:
        with self._lock:
            clock = self._gangs.get(gang)
            if clock is None or "feasible" in clock:
                return
            clock["feasible"] = now
            wait = max(0.0, now - clock["arrival"])
        if self._metrics:
            m.GANG_WAIT_SECONDS.labels(stage="first_feasible").observe(wait)

    def note_gang_bound(self, gang: str, now: float) -> None:
        with self._lock:
            clock = self._gangs.pop(gang, None)
            if clock is None:
                return
            clock["bound"] = now
            wait = max(0.0, now - clock["arrival"])
            self.recent_gangs.append({
                "gang": gang, "wait_seconds": round(wait, 6),
                "feasible_after": (round(clock["feasible"] - clock["arrival"], 6)
                                   if "feasible" in clock else None)})
            listeners = list(self._gang_bound_listeners)
        if self._metrics:
            m.GANG_WAIT_SECONDS.labels(stage="bound").observe(wait)
        # outside the lock: a listener may read the ledger
        for listener in listeners:
            try:
                listener(gang, now, wait)
            except Exception:
                log.exception("gang-bound listener failed for %s", gang)

    def add_gang_bound_listener(self, listener: Any) -> None:
        """``listener(gang, now, wait_seconds)`` runs after every gang-bound
        observation, outside the ledger's lock."""
        with self._lock:
            self._gang_bound_listeners.append(listener)

    def drop_gang(self, gang: str) -> None:
        """Forget a gang's clock (it timed out and will not bind)."""
        with self._lock:
            self._gangs.pop(gang, None)

    def gang_clocks(self) -> Dict[str, Dict[str, float]]:
        """The live gang wait clocks (gang → stamps)."""
        with self._lock:
            return {gang: dict(clock) for gang, clock in self._gangs.items()}

    # ------------------------------------------------------------ exports

    def _totals(self) -> Dict[str, Any]:
        return {
            "total": self.total_gb_seconds,
            "busy": self.busy_gb_seconds,
            "idle": dict(self.idle_gb_seconds),
            "reasons": dict(self.pending_reason_seconds),
            "pools": {k: dict(v) for k, v in self.by_pool.items()},
            "namespaces": dict(self.by_namespace),
        }

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            return self._totals()

    def mean_reconfig_seconds(self, default: float = 0.5) -> float:
        """The measured mean re-carve latency (frozen edge to edge);
        ``default`` before the first completed re-carve."""
        with self._lock:
            if self.reconfig_count <= 0:
                return default
            return self.reconfig_seconds_total / self.reconfig_count

    def reconfig_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self.reconfig_count,
                    "seconds_total": self.reconfig_seconds_total,
                    "in_flight": sorted(self._reconfig_started)}

    def utilization(self) -> float:
        with self._lock:
            if self.total_gb_seconds <= 0:
                return 0.0
            return self.busy_gb_seconds / self.total_gb_seconds

    def idle_pending_fraction(self) -> float:
        with self._lock:
            if self.total_gb_seconds <= 0:
                return 0.0
            return self.idle_gb_seconds[BUCKET_PENDING] / self.total_gb_seconds

    # -------------------------------------------------------- self check

    def _canonical_state(self) -> Dict[str, Any]:
        return {"nodes": {n: st.canonical() for n, st in self._nodes.items()},
                "bound": dict(self._bound), "pending": dict(self._pending),
                "quotas": dict(self._quotas)}

    def self_check(self, store: Optional[NodeStore] = None) -> List[str]:
        """The incremental state against a recomputation from the store;
        empty when they agree. Clean (skipped) while the store has moved
        past the watermark: the comparison would race the writers."""
        store = store if store is not None else self.store
        with self._lock:
            if store.revision != self._revision:
                return []
            live = self._canonical_state()
        shadow = state_from_store(store)
        if store.revision != self._revision:
            return []
        diffs: List[str] = []
        for section in ("nodes", "bound", "pending", "quotas"):
            a, b = live[section], shadow[section]
            for key in sorted(set(a) | set(b)):
                if a.get(key) != b.get(key):
                    diffs.append(f"{section}[{key}]: incremental={a.get(key)!r} "
                                 f"store={b.get(key)!r}")
        return diffs


def state_from_store(store: NodeStore) -> Dict[str, Any]:
    """The ledger's state recomputed from the store: the shadow side of
    ``CapacityLedger.self_check``."""
    nodes: Dict[str, tuple] = {}
    for node in store.list("Node", copy=False):
        total = node_gb(node)
        if total > 0:
            nodes[node.name] = _NodeState(node, total).canonical()
    bound: Dict[str, Tuple[str, int, str]] = {}
    pending: Dict[str, Tuple[int, str]] = {}
    for pod in store.list("Pod", copy=False):
        entry = _pod_entry(pod)
        if entry is not None:
            (bound if entry[0] == "bound" else pending)[pod.namespaced_name] = entry[1]
    quotas = {f"{q.namespace}/{q.name}": _quota_entry(q)
              for q in store.list("ElasticQuota", copy=False)}
    return {"nodes": nodes, "bound": bound, "pending": pending, "quotas": quotas}
