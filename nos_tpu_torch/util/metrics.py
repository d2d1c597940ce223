"""Prometheus-text metrics registry: the port's own copy of
``nos_tpu/util/metrics.py``.

Counters, gauges and histograms are label families:
``counter.labels(model="m")`` returns a child series, rendered as
``name{model="m"}``; label values are escaped as the text exposition
format asks. Beside the families (under the reference's ``nos_tpu_``
names, so equal emissions render to equal bytes), the registry keeps the
reference's three fleet-size mechanisms, all off by default:

- **the cardinality governor**: ``apply_series_budgets`` gives a family a
  series budget. Once it holds ``budget`` exact children, a new label set
  folds into one ``_other`` child of its label keys and counts once, by
  family, in ``nos_tpu_metric_series_dropped_total``. Admission depends
  only on which label sets already exist, so the same emissions fold the
  same way, and the overflow child keeps every refused increment.
  ``restore_series_budgets`` puts the previous budgets back;
  ``series_report`` gives each family's exact, overflow and dropped
  counts.
- **child delete**: ``remove(**labels)`` drops a child series (a deleted
  object's series leave the exposition); ``LABEL_RESET_PATHS`` names the
  code that removes each per-object family.
- **the incremental snapshot**: ``cursor()`` returns a ``SnapshotCursor``
  whose ``collect()`` gives the series touched, and the keys removed,
  since its last call (the timeline's sample cost follows the changes).

``snapshot()`` reads every touched series at once (a histogram as
``_count``, ``_sum`` and, once observed, ``_p50`` / ``_p95`` / ``_p99``
over its last ``WINDOW`` observations): ``/debug/vars``. The invariant
auditor counts its violations in ``nos_tpu_audit_violations_total``
(``record/audit.py``); the families of the capacity ledger's gauges,
fragmentation, quota and chaos wait for their emitters (ROADMAP.md,
item 18b.3).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

# the label value every refused series folds into; a Kubernetes name
# cannot start with "_", so it names no object
OTHER_LABEL = "_other"


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{key}="{escape_label_value(value)}"' for key, value in sorted(labels.items())
    )
    return "{" + inner + "}"


def _admit_child(family, label_values: Dict[str, str]):
    """``labels()``: the child of this label set, created on first use;
    at the family's budget a new label set gets the ``_other`` child of
    its label keys instead."""
    if family._label_values:
        raise ValueError(f"{family.name}: labels() on an already-labeled child")
    key = tuple(sorted((k, str(v)) for k, v in label_values.items()))
    dropped_new = False
    with family._lock:
        child = family._children.get(key)
        if child is None:
            budget = family._budget
            exact = len(family._children) - family._overflow_children
            if budget is not None and exact >= budget:
                refused = hash(key)
                if refused not in family._dropped_hashes:
                    family._dropped_hashes.add(refused)
                    dropped_new = True
                okey = tuple((k, OTHER_LABEL) for k, _ in key)
                child = family._children.get(okey)
                if child is None:
                    child = family._new_child({k: OTHER_LABEL for k, _ in key})
                    child._is_overflow = True
                    family._children[okey] = child
                    family._overflow_children += 1
                    family._children_sorted = None
            else:
                child = family._new_child({k: str(v) for k, v in label_values.items()})
                family._children[key] = child
                family._children_sorted = None
    if dropped_new and family._on_drop is not None:
        family._on_drop(family.name)
    return child


class _Family:
    """What every metric type shares: a parent holds its children keyed
    by their sorted label items, the governor's state and the registry's
    hooks (``_mark`` feeds the cursors' dirty set and is set only while a
    cursor exists; ``_mark_removed`` tells them of a removal; ``_on_drop``
    counts a refusal)."""

    def __init__(self, name: str, help_text: str, label_values=None) -> None:
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._label_values: Dict[str, str] = dict(label_values or {})
        self._label_suffix = render_labels(self._label_values)
        self._children: Dict[Tuple, "_Family"] = {}
        self._children_sorted: Optional[list] = None
        self._touched = False
        self._budget: Optional[int] = None
        self._overflow_children = 0
        self._dropped_hashes: Set[int] = set()
        self._is_overflow = False
        self._mark = None
        self._mark_removed = None
        self._on_drop = None

    def _make_child(self, label_values: Dict[str, str]) -> "_Family":
        raise NotImplementedError

    def _new_child(self, label_values: Dict[str, str]) -> "_Family":
        child = self._make_child(label_values)
        child._mark = self._mark
        return child

    def labels(self, **label_values: str):
        """The child series of this label set (see ``OTHER_LABEL``)."""
        return _admit_child(self, label_values)

    def remove(self, **label_values: str) -> bool:
        """Drop the child series of this label set; False when absent. Its
        slot counts against the budget again; the dropped count stays."""
        key = tuple(sorted((k, str(v)) for k, v in label_values.items()))
        with self._lock:
            child = self._children.pop(key, None)
            if child is None:
                return False
            if child._is_overflow:
                self._overflow_children -= 1
            self._children_sorted = None
        if self._mark_removed is not None:
            self._mark_removed(child)
        return True

    def _sorted_children(self):
        with self._lock:
            if self._children_sorted is None:
                self._children_sorted = [child for _, child in sorted(self._children.items())]
            return self._children_sorted

    def snapshot_into(self, out: Dict[str, float]) -> None:
        self.snapshot_self_into(out)
        if self._children:
            for child in self._sorted_children():
                child.snapshot_into(out)


class Counter(_Family):
    TYPE = "counter"

    def __init__(self, name: str, help_text: str, label_values=None) -> None:
        super().__init__(name, help_text, label_values)
        self._value = 0.0
        self._snapshot_key = f"{name}{self._label_suffix}"

    def _make_child(self, label_values):
        return type(self)(self.name, self.help, label_values)

    def _removed_snapshot_keys(self) -> Tuple[str, ...]:
        return (self._snapshot_key,)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._touched = True
        if self._mark is not None:
            self._mark(self)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def total(self) -> float:
        """Its own value and every child's."""
        with self._lock:
            children = list(self._children.values())
            own = self._value
        return own + sum(c.value for c in children)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.TYPE}"]
        with self._lock:
            # the bare parent once touched, or when it has no children
            if self._touched or not self._children:
                lines.append(f"{self.name}{self._label_suffix} {self._value}")
        for child in self._sorted_children():
            with child._lock:
                lines.append(f"{child.name}{child._label_suffix} {child._value}")
        return "\n".join(lines) + "\n"

    def snapshot_self_into(self, out: Dict[str, float]) -> None:
        """This series alone, once touched."""
        with self._lock:
            touched, value = self._touched, self._value
        if touched:
            out[self._snapshot_key] = value


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._touched = True
        if self._mark is not None:
            self._mark(self)


class Histogram(_Family):
    DEFAULT_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
    # percentiles read the last WINDOW observations; counts, sums and
    # buckets stay exact
    WINDOW = 1024

    def __init__(self, name: str, help_text: str,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 label_values=None) -> None:
        super().__init__(name, help_text, label_values)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._recent: deque = deque(maxlen=self.WINDOW)
        self._ordered: Optional[list] = None  # the sorted window, rebuilt lazily
        self._snapshot_keys = tuple(f"{name}_{part}{self._label_suffix}"
                                    for part in ("count", "sum", "p50", "p95", "p99"))

    def _make_child(self, label_values):
        return Histogram(self.name, self.help, self.buckets, label_values)

    def _removed_snapshot_keys(self) -> Tuple[str, ...]:
        return self._snapshot_keys

    def observe(self, value: float) -> None:
        with self._lock:
            self._touched = True
            self._sum += value
            self._count += 1
            self._recent.append(value)
            self._ordered = None
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
        if self._mark is not None:
            self._mark(self)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._recent:
                return None
            if self._ordered is None:
                self._ordered = sorted(self._recent)
            ordered = self._ordered
            return ordered[min(len(ordered) - 1, int(p / 100.0 * len(ordered)))]

    def _sample_lines(self) -> list:
        with self._lock:
            if not (self._touched or not self._children):
                return []
            base = dict(self._label_values)
            lines = []
            cumulative = 0
            for bound, count in zip(self.buckets, self._counts):
                cumulative += count
                lines.append(f"{self.name}_bucket{render_labels({**base, 'le': str(bound)})} "
                             f"{cumulative}")
            cumulative += self._counts[-1]
            lines.append(f"{self.name}_bucket{render_labels({**base, 'le': '+Inf'})} "
                         f"{cumulative}")
            lines.append(f"{self.name}_sum{self._label_suffix} {self._sum}")
            lines.append(f"{self.name}_count{self._label_suffix} {self._count}")
            return lines

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        lines.extend(self._sample_lines())
        for child in self._sorted_children():
            lines.extend(child._sample_lines())
        return "\n".join(lines) + "\n"

    def snapshot_self_into(self, out: Dict[str, float]) -> None:
        """Count and sum always (an empty histogram's zeros are part of the
        exposition), the percentiles once observed."""
        key_count, key_sum, key_p50, key_p95, key_p99 = self._snapshot_keys
        with self._lock:
            out[key_count] = self._count
            out[key_sum] = self._sum
            if self._recent:
                if self._ordered is None:
                    self._ordered = sorted(self._recent)
                ordered = self._ordered
                last = len(ordered) - 1
                for p, key in ((50, key_p50), (95, key_p95), (99, key_p99)):
                    out[key] = ordered[min(last, int(p / 100.0 * len(ordered)))]


class SnapshotCursor:
    """``collect()`` gives ``(changed, removed_keys)`` since its last call;
    the first call gives the whole snapshot. A series updates its value
    before it marks itself dirty, and a drain swaps the dirty set before
    it reads, so no update is lost (one may come twice)."""

    def __init__(self, registry: "MetricsRegistry") -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._pending: Set[object] = set()
        self._removed: Set[str] = set()
        self._primed = False

    def collect(self) -> Tuple[Dict[str, float], List[str]]:
        reg = self._registry
        if not self._primed:
            with self._lock:
                self._primed = True
                self._pending.clear()
                self._removed.clear()
            return reg.snapshot(), []
        reg._drain_dirty()
        with self._lock:
            pending, self._pending = self._pending, set()
            removed = sorted(self._removed)
            self._removed.clear()
        out: Dict[str, float] = {}
        for series in pending:
            series.snapshot_self_into(out)
        for key in removed:  # changed and removed in one window: removed
            out.pop(key, None)
        return out, removed

    def close(self) -> None:
        """Stop collecting deltas."""
        reg = self._registry
        with reg._dirty_lock:
            if self in reg._cursors:
                reg._cursors.remove(self)


METRIC_SERIES_DROPPED_NAME = "nos_tpu_metric_series_dropped_total"


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        # the series touched since the last drain, for the cursors;
        # _marking stays False until the first cursor attaches
        self._dirty: Set[object] = set()
        self._dirty_lock = threading.Lock()
        self._cursors: List[SnapshotCursor] = []
        self._marking = False
        # budgets of families not created yet
        self._pending_budgets: Dict[str, Optional[int]] = {}
        self._default_budget: Optional[int] = None

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_text, buckets))

    def _get_or_create(self, name: str, factory):
        with self._lock:
            if name not in self._metrics:
                metric = factory()
                metric._mark_removed = self._mark_removed
                metric._on_drop = self._note_dropped
                if name != METRIC_SERIES_DROPPED_NAME:
                    metric._budget = self._pending_budgets.get(name, self._default_budget)
                if self._marking:
                    metric._mark = self._mark_dirty
                self._metrics[name] = metric
            return self._metrics[name]

    # ------------------------------------------------ incremental snapshot

    def _mark_dirty(self, series) -> None:
        with self._dirty_lock:
            self._dirty.add(series)

    def _mark_removed(self, series) -> None:
        keys = series._removed_snapshot_keys()
        with self._dirty_lock:
            self._dirty.discard(series)
            for cursor in self._cursors:
                with cursor._lock:
                    cursor._removed.update(keys)

    def _drain_dirty(self) -> None:
        with self._dirty_lock:
            if not self._dirty:
                return
            drained, self._dirty = self._dirty, set()
            cursors = list(self._cursors)
        for cursor in cursors:
            with cursor._lock:
                cursor._pending |= drained

    def cursor(self) -> SnapshotCursor:
        """A consumer of the deltas (each cursor sees every one); close it
        when done."""
        cursor = SnapshotCursor(self)
        with self._lock:
            metrics = list(self._metrics.values())
        with self._dirty_lock:
            self._cursors.append(cursor)
            self._marking = True
        for metric in metrics:
            metric._mark = self._mark_dirty
            with metric._lock:
                children = list(metric._children.values())
            for child in children:
                child._mark = self._mark_dirty
        return cursor

    # ------------------------------------------------ cardinality governor

    def _note_dropped(self, family: str) -> None:
        self.counter(
            METRIC_SERIES_DROPPED_NAME,
            "Distinct label sets refused by a family's series budget and folded into its "
            "_other child (by family)").labels(family=family).inc()

    def apply_series_budgets(self, budgets: Optional[Dict[str, int]] = None,
                             default: Optional[int] = None) -> dict:
        """Set the families' series budgets (``default`` for every family
        without one; None: unbudgeted). A budget gates new admissions
        only. The previous state, for ``restore_series_budgets``."""
        budgets = dict(budgets or {})
        budgets.pop(METRIC_SERIES_DROPPED_NAME, None)
        with self._lock:
            metrics = dict(self._metrics)
            prev = {"default": self._default_budget, "pending": dict(self._pending_budgets),
                    "families": {name: metric._budget for name, metric in metrics.items()}}
            self._default_budget = default
            self._pending_budgets = dict(budgets)
        for name, metric in metrics.items():
            if name != METRIC_SERIES_DROPPED_NAME:
                metric._budget = budgets.get(name, default)
        return prev

    def restore_series_budgets(self, prev: dict) -> None:
        with self._lock:
            metrics = dict(self._metrics)
            self._default_budget = prev["default"]
            self._pending_budgets = dict(prev["pending"])
        for name, budget in prev["families"].items():
            metric = metrics.get(name)
            if metric is not None:
                metric._budget = budget

    def series_report(self) -> Dict[str, dict]:
        """family → its exact and overflow children, the distinct label
        sets it refused and its budget; families with children or a
        budget only."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, dict] = {}
        for name in sorted(metrics):
            metric = metrics[name]
            with metric._lock:
                total = len(metric._children)
                overflow = metric._overflow_children
                dropped = len(metric._dropped_hashes)
                budget = metric._budget
            if total or budget is not None:
                out[name] = {"exact": total - overflow, "overflow": overflow,
                             "dropped": dropped, "budget": budget}
        return out

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.render() for m in sorted(metrics, key=lambda m: m.name))

    def snapshot(self) -> Dict[str, float]:
        """Every touched series by its exposition key."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, float] = {}
        for metric in metrics.values():
            metric.snapshot_into(out)
        return out


# The process-wide registry of the port.
REGISTRY = MetricsRegistry()

# Serving engine.
SERVE_REQUESTS = REGISTRY.counter(
    "nos_tpu_serve_requests_total", "Requests completed by the serving engine"
)
SERVE_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_tokens_total", "Tokens generated by the serving engine"
)
SERVE_TICKS = REGISTRY.counter(
    "nos_tpu_serve_decode_ticks_total",
    "Batched decode ticks executed (each reads the weights once)",
)
SERVE_SLOT_TICKS_ACTIVE = REGISTRY.counter(
    "nos_tpu_serve_slot_ticks_active_total",
    "Per-slot ticks spent on live requests (active / (ticks*slots) = "
    "batch occupancy)",
)
SERVE_PREFIX_HITS = REGISTRY.counter(
    "nos_tpu_serve_prefix_cache_hits_total",
    "Chunked admissions that reused a cached prompt-prefix K/V",
)
SERVE_PREFIX_TOKENS_REUSED = REGISTRY.counter(
    "nos_tpu_serve_prefix_tokens_reused_total",
    "Prompt tokens whose prefill was skipped via the prefix cache",
)
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "nos_tpu_serve_queue_depth", "Requests waiting for a free slot"
)
SERVE_SLOTS = REGISTRY.gauge(
    "nos_tpu_serve_slots", "Configured slot count (the occupancy denominator)"
)

# Per-request serving latency (serve/telemetry.py), observed at retire,
# labeled model/adapter/bucket.
_SERVE_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
SERVE_TTFT = REGISTRY.histogram(
    "nos_tpu_serve_ttft_seconds",
    "Time to first token: submit to the first token EMITTED to the host "
    "(by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_TPOT = REGISTRY.histogram(
    "nos_tpu_serve_tpot_seconds",
    "Time per output token: (last token - first token) / (tokens - 1) "
    "(by model, adapter, bucket)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
SERVE_E2E = REGISTRY.histogram(
    "nos_tpu_serve_e2e_seconds",
    "End-to-end request latency, submit to retire (by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_QUEUE_WAIT = REGISTRY.histogram(
    "nos_tpu_serve_queue_wait_seconds",
    "Submit-to-admission wait for a free slot (by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_REQUEST_TOKENS_PER_S = REGISTRY.histogram(
    "nos_tpu_serve_request_tokens_per_second",
    "Per-request decode throughput: tokens / e2e latency "
    "(by model, adapter, bucket)",
    buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0),
)
SERVE_GOODPUT_REQUESTS = REGISTRY.counter(
    "nos_tpu_serve_goodput_requests_total",
    "Completed requests by latency verdict (verdict=good|late) (by model)",
)
SERVE_GOODPUT_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_goodput_tokens_total",
    "Tokens from requests that met their latency targets (by model)",
)

# Speculative decoding (serve/spec_engine.py): acceptance telemetry. The
# accept rate is accepted / draft; accepted / rounds over active
# row-rounds is stats()['mean_accepted'].
SERVE_SPEC_ROUNDS = REGISTRY.counter(
    "nos_tpu_serve_spec_rounds_total",
    "Speculative rounds executed per active row (row-rounds): each drafts "
    "k tokens and commits 1..k+1",
)
SERVE_SPEC_DRAFT_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_spec_draft_tokens_total",
    "Draft tokens proposed to the target verifier (k per active row-round)",
)
SERVE_SPEC_ACCEPTED_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_spec_accepted_tokens_total",
    "Draft tokens the target accepted (committed - 1 per active row-round; "
    "the bonus token is not a draft acceptance)",
)

# MIG node agent (controllers/migagent): instances it carved and destroyed.
MIG_INSTANCES_CREATED = REGISTRY.counter(
    "nos_tpu_mig_instances_created_total", "MIG instances created by node agents (by profile)"
)
MIG_INSTANCES_DELETED = REGISTRY.counter(
    "nos_tpu_mig_instances_deleted_total", "MIG instances destroyed by node agents (by profile)"
)

# The partitioner's planner (partitioning/core, controllers/partitioner).
PLAN_DURATION = REGISTRY.histogram(
    "nos_tpu_plan_duration_seconds",
    "Planner.plan() wall time per invocation",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)
PLANS_APPLIED = REGISTRY.counter(
    "nos_tpu_partitioning_plans_applied_total", "Partitioning plans actuated"
)
PLAN_VERDICT_CACHE = REGISTRY.counter(
    "nos_tpu_plan_verdict_cache_total",
    "Planner verdict-cache lookups by outcome (event=hit|miss|bypass), flushed once "
    "per plan()",
)
PLAN_CARVE_FUTILITY = REGISTRY.counter(
    "nos_tpu_plan_carve_futility_total",
    "Carve attempts skipped because a (node version, lacking signature) memo already "
    "proved them futile; flushed once per plan()",
)
PLAN_MODE = REGISTRY.counter(
    "nos_tpu_plan_mode_total",
    "Planner.plan() invocations by mode (mode=incremental|full|fallback): incremental "
    "keeps the previous plan's memos still valid over a persistent base snapshot, "
    "fallback replans from scratch but preserves the base, full consumes the snapshot",
)
PLAN_POOL_COUNT = REGISTRY.gauge(
    "nos_tpu_plan_pool_count",
    "Pools the last sharded plan partitioned the cluster into (by kind)",
)
PLAN_POOL_DURATION = REGISTRY.histogram(
    "nos_tpu_plan_pool_duration_seconds",
    "One pool's plan() wall time within a sharded plan (by pool)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)
PLAN_MERGE_CONFLICTS = REGISTRY.counter(
    "nos_tpu_plan_merge_conflicts_total",
    "Sharded plans whose merge checks failed (a node claimed twice or unplanned, a GPU "
    "listed twice, capacity exceeded): the plan is discarded and the pools rebuilt",
)
PLAN_BACKEND = REGISTRY.counter(
    "nos_tpu_plan_backend_total",
    "Pool plans by backend (backend=serial|thread|process|escalated): escalated counts "
    "the pools a process-backend plan planned in the parent for want of a worker",
)
WARM_BOOT_OUTCOME = REGISTRY.counter(
    "nos_tpu_warm_boot_outcome_total",
    "Warm-state adoptions on a new base by outcome (outcome=adopted|partial|cold): "
    "every node's signature matched, some did, or none",
)
DIVERGENCE_REPLANS = REGISTRY.counter(
    "nos_tpu_partitioning_divergence_replans_total",
    "Immediate replans triggered by actuation diverging from spec",
)
SNAPSHOT_FORKS = REGISTRY.counter(
    "nos_tpu_snapshot_forks_total", "Snapshot forks started by the planner"
)
SNAPSHOT_COMMITS = REGISTRY.counter(
    "nos_tpu_snapshot_commits_total", "Snapshot forks committed (trial kept)"
)
SNAPSHOT_REVERTS = REGISTRY.counter(
    "nos_tpu_snapshot_reverts_total", "Snapshot forks reverted (trial discarded)"
)

# The drain reservation (scheduler/plugins/reservation.py).
BOARD_RESERVATIONS = REGISTRY.counter(
    "nos_tpu_board_reservations_total", "Nodes reserved to drain for whole-GPU pods"
)

# CapacityScheduling's preemptor (scheduler/preemption.py).
PREEMPTIONS = REGISTRY.counter(
    "nos_tpu_preemptions_total", "Pods evicted by quota preemption (by victim namespace)"
)

# The model autoscaler (controllers/autoscaler).
_WAIT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0)
AUTOSCALER_REPLICAS = REGISTRY.gauge(
    "nos_tpu_autoscaler_replicas",
    "Replica counts per ModelServing (by model, state=desired|ready)",
)
AUTOSCALER_DECISIONS = REGISTRY.counter(
    "nos_tpu_autoscaler_decisions_total",
    "Autoscaler verdicts per reconcile "
    "(by verdict=hold|scale-up|scale-down|scale-to-zero|cold-start)",
)
AUTOSCALER_COLD_START_SECONDS = REGISTRY.histogram(
    "nos_tpu_autoscaler_cold_start_seconds",
    "Time from a scaled-to-zero model's wake decision to its first replica "
    "binding (the carve included)",
    buckets=_WAIT_BUCKETS,
)

# The capacity ledger (capacity/ledger.py), in GB of GPU memory.
CAPACITY_GB_SECONDS = REGISTRY.counter(
    "nos_tpu_capacity_gb_seconds_total",
    "GPU-memory GB-seconds integrated between observations, by "
    "state=busy|no-demand|pending-unschedulable|reconfig|reserved-by-gang"
    "|autoscaler-grace (reason: the dominant unserved-reason prefix of "
    "pending-unschedulable)",
)
GANG_WAIT_SECONDS = REGISTRY.histogram(
    "nos_tpu_gang_wait_seconds",
    "Gang wait from arrival, by stage=first_feasible|bound",
    buckets=_WAIT_BUCKETS,
)

# The placement forecaster (forecast/).
GANG_ETA_SECONDS = REGISTRY.histogram(
    "nos_tpu_gang_eta_seconds",
    "Forecast earliest-start ETA per pending gang "
    "(by stage=feasible-now|recarve|blocked; a blocked gang without "
    "expected-completion hints publishes none)",
    buckets=_WAIT_BUCKETS,
)
FORECAST_ACCURACY_RATIO = REGISTRY.gauge(
    "nos_tpu_forecast_accuracy_ratio",
    "Rolling forecast calibration: absolute ETA error over the gang's "
    "arrival-to-bound wait (by quantile=p50|p95)",
)
BACKFILL_UNSAFE_TOTAL = REGISTRY.counter(
    "nos_tpu_backfill_unsafe_total",
    "Backfill trials whose (small pod, node) placement would delay the "
    "oldest pending gang",
)
FORECAST_RUNS = REGISTRY.counter(
    "nos_tpu_forecast_runs_total",
    "Completed forecast cycles",
)

# The kube substrate (kube/store.py, kube/controller.py, util/loop_health.py,
# kube/apistore.py, kube/leaderelection.py), under the reference's names
# (``nos_tpu/util/metrics.py:796-1031``).
LEADER_TRANSITIONS = REGISTRY.counter(
    "nos_tpu_leader_transitions_total",
    "Leadership acquisitions across all components' leases",
)
WATCH_RECONNECTS = REGISTRY.counter(
    "nos_tpu_watch_reconnects_total",
    "Informer watch streams re-established after an error, disconnect, "
    "or 410 expiry (by kind)",
)
CONTROLLER_BUSY = REGISTRY.gauge(
    "nos_tpu_controller_busy_fraction",
    "Fraction of the last ~1 s window a control loop spent doing work "
    "rather than waiting for it (by loop)",
)
WATCH_DRAIN_LAG = REGISTRY.histogram(
    "nos_tpu_watch_drain_lag_seconds",
    "Age of a WatchEvent at dequeue: monotonic enqueue-to-drain delay "
    "per consuming loop (by consumer); a growing lag means the consumer "
    "is saturated",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0),
)
WATCH_QUEUE_DEPTH = REGISTRY.gauge(
    "nos_tpu_watch_queue_depth",
    "Events waiting in a watch subscriber's (unbounded) queue "
    "(by kind_set: the subscriber's name, or its joined kind set when "
    "anonymous)",
)
STORE_LOCK_WAIT = REGISTRY.counter(
    "nos_tpu_store_lock_wait_seconds_total",
    "Seconds callers spent blocked on the store lock, sampled at "
    "contention: the uncontended path records nothing",
)
STORE_LOCK_CONTENTION = REGISTRY.counter(
    "nos_tpu_store_lock_contention_total",
    "Store lock acquisitions that had to wait for another holder",
)

# The components (cmd/, kube/webhook.py), under the reference's names.
WEBHOOK_DENIALS = REGISTRY.counter(
    "nos_tpu_webhook_denials_total",
    "AdmissionReview requests the validating webhooks denied",
)

# The observability plane (util/profiling.py, timeline/, the governor,
# util/tracing.py's retention), under the reference's names and help
# (``nos_tpu/util/metrics.py:1046-1055``, ``:1087-1108``, ``:1119``).
PROFILER_SAMPLES = REGISTRY.counter(
    "nos_tpu_profiler_samples_total",
    "Stack samples captured from registered controller threads by the "
    "sampling profiler",
)
PROFILER_OVERHEAD = REGISTRY.gauge(
    "nos_tpu_profiler_overhead_fraction",
    "Sampler duty cycle: time spent capturing stacks divided by wall "
    "time enabled (the profiler's measured overhead budget)",
)
TIMELINE_SAMPLES = REGISTRY.counter(
    "nos_tpu_timeline_samples_total",
    "Samples appended to the timeline ring (one per sampler interval)",
)
TIMELINE_SERIES = REGISTRY.gauge(
    "nos_tpu_timeline_series",
    "Distinct series present in the most recent timeline sample",
)
# the flight recorder's invariant auditor (record/audit.py)
AUDIT_VIOLATIONS = REGISTRY.counter(
    "nos_tpu_audit_violations_total",
    "Invariant-auditor checks whose shadow recompute disagreed with the "
    "incremental structure (verdict cache, lacking totals, free pool, "
    "mutation clock, carve-futility memo, capacity ledger) (by check)",
)
TIMELINE_FINDINGS = REGISTRY.counter(
    "nos_tpu_timeline_findings_total",
    "New detector findings over the timeline ring "
    "(by detector=stall|leak|regression, series); hysteresis means an "
    "active finding counts once, not once per tick",
)
TIMELINE_SAMPLE_DURATION = REGISTRY.histogram(
    "nos_tpu_timeline_sample_duration_seconds",
    "Wall time one timeline sample (all collectors + ring append) costs "
    "— the numerator of the <=2% sampling-overhead budget",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1),
)
METRIC_SERIES_DROPPED = REGISTRY.counter(
    METRIC_SERIES_DROPPED_NAME,
    "Distinct label sets refused by a family's series budget and folded "
    "into its _other child (by family)",
)
TRACE_RETAINED = REGISTRY.counter(
    "nos_tpu_trace_retained_total",
    "Traces pinned into the tail-kept reservoir "
    "(by verdict=error|unschedulable|slow)",
)

# Each family labeled by node, pool or model names the code that removes
# a series when its object goes away, or says why it keeps it.
LABEL_RESET_PATHS: Dict[str, str] = {
    "nos_tpu_autoscaler_replicas":
        "ModelServingReconciler removes a ModelServing's series when it is deleted",
}
LABEL_RESET_EXEMPT: Dict[str, str] = {
    "nos_tpu_plan_pool_duration_seconds": (
        "histogram of completed plan durations keyed by the operator's static pool set "
        "(bounded by config, not by cluster objects); history must survive pool "
        "reconfiguration for trend comparison"),
    "nos_tpu_serve_goodput_requests_total": (
        "monotonic per-model counters; deleting on model teardown would erase goodput "
        "history mid-scrape and break rate(), bounded by the deployed-model set and "
        "governable by a series budget"),
    "nos_tpu_serve_goodput_tokens_total": (
        "as nos_tpu_serve_goodput_requests_total: monotonic goodput history outlives the "
        "model object by design"),
}
