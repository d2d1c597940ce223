"""Observability bench on H100 nodes: the port's counterpart of
``bench_observability.py`` (the telemetry stack at fleet size).

    python3 -m nos_tpu_torch.bench_observability [--size reference|quick|card]

It rides ``bench_store.seed_store`` (8-H100 MIG nodes, one-GPU pods bound
round-robin, a pending residue), derives each node's GPU accounting from
the seeded store and publishes it as a capacity ledger would, one
``{node, state}`` series triple a node and exact per-pool rollups. Then
it measures what the control loops pay for:

- exposition: ``MetricsRegistry.render()`` with the cardinality governor
  off and on (``NODE_BUDGET`` exact node series, the rest folded into
  ``_other``);
- the incremental snapshot: ``SnapshotCursor.collect()`` after a quiet
  interval's touches (``TOUCHED_PER_FRAME`` series);
- the timeline: ``TimelineStore.sample_once()`` in cursor mode over the
  governed registry;
- retention: a fixed mixture of journeys (boring, slow, error) through
  the tail-kept ``TraceStore``.

The report's fields are functions of the size: series counts, exposition
bytes, the governed exposition's sha256 and whether two governed
registries built apart render byte-identically, the retention hit rate,
and the ``*_within_budget`` booleans, each holding a governed path's
median to 2% of the 5 s control cycle (100 ms). The wall-clock timings
are a separate row. The synthetic families keep the reference's names
and help (``nos_tpu_capacity_node_chips``, ``nos_tpu_capacity_pool_chips``):
under the translation a node's 8 slots are an H100 node's 8 GPUs where
the reference's are a v5e board's 8 chips, and a pod holds one, so the
exposition text, and its sha256, equal the reference's at every size.

Sizes: ``reference()`` 1,000 nodes x 10,000 pods (the smoke's),
``quick()`` 100 x 1,000 at two repeats, ``card()`` the reference's
default pair, 1,000 x 10,000 and 100,000 x 1,000,000. Wall-clock figures
go to stdout only. The module imports no torch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Tuple

from nos_tpu_torch.bench_store import seed_store
from nos_tpu_torch.gpu.node import RESOURCE_GPU
from nos_tpu_torch.timeline.sizes import SizeRegistry
from nos_tpu_torch.timeline.store import TimelineStore
from nos_tpu_torch.timeline.watchdog import WedgeWatchdog
from nos_tpu_torch.util.metrics import MetricsRegistry
from nos_tpu_torch.util.tracing import RetentionPolicy, Span, Trace, TraceStore

CYCLE_SECONDS = 5.0
BUDGET_FRACTION = 0.02  # a governed path's median within 2% of the cycle
NODE_FAMILY = "nos_tpu_capacity_node_chips"
POOL_FAMILY = "nos_tpu_capacity_pool_chips"
NODE_STATES = ("used", "free", "stranded")
N_POOLS = 8
NODE_BUDGET = 4096  # the exact node series the governor admits
TOUCHED_PER_FRAME = 256  # the series a quiet interval changes
SLOW_THRESHOLDS = {"pod.journey": 1.0}


@dataclass(frozen=True)
class ObservabilitySizes:
    configs: Tuple[Tuple[int, int], ...]  # (nodes, pods) each
    repeats: int = 5

    @classmethod
    def reference(cls) -> "ObservabilitySizes":
        return cls(configs=((1000, 10000),))

    @classmethod
    def quick(cls) -> "ObservabilitySizes":
        return cls(configs=((100, 1000),), repeats=2)

    @classmethod
    def card(cls) -> "ObservabilitySizes":
        return cls(configs=((1000, 10000), (100000, 1000000)))


SIZES = {"reference": ObservabilitySizes.reference, "quick": ObservabilitySizes.quick,
         "card": ObservabilitySizes.card}


def fleet_from_store(store):
    """(node, GPUs, GPUs bound) rows, by name, and the pending pods."""
    used: dict = {}
    pending = 0
    for pod in store.list("Pod", copy=False):
        if pod.node:
            used[pod.node] = used.get(pod.node, 0) + pod.request.get(RESOURCE_GPU, 0)
        else:
            pending += 1
    fleet = [(node.name, int(node.allocatable.get(RESOURCE_GPU, 0)), used.get(node.name, 0))
             for node in store.list("Node", copy=False)]
    return fleet, pending


def emit_fleet(registry, fleet, pending):
    """One ``{node, state}`` triple a node, the per-pool rollups and the
    pending gauge; the node family."""
    node_g = registry.gauge(NODE_FAMILY, "per-node chip accounting")
    pool_g = registry.gauge(POOL_FAMILY, "per-pool chip rollups")
    pending_g = registry.gauge("nos_tpu_capacity_pending_pods", "unbound pods")
    pools: dict = {}
    for i, (name, cap, used) in enumerate(fleet):
        free = cap - used
        stranded = 1 if 0 < used < cap else 0
        node_g.labels(node=name, state="used").set(float(used))
        node_g.labels(node=name, state="free").set(float(free))
        node_g.labels(node=name, state="stranded").set(float(stranded))
        acc = pools.setdefault(f"pool-{i % N_POOLS}", [0, 0, 0])
        acc[0] += used
        acc[1] += free
        acc[2] += stranded
    for pool in sorted(pools):
        for state, value in zip(NODE_STATES, pools[pool]):
            pool_g.labels(pool=pool, state=state).set(float(value))
    pending_g.set(float(pending))
    return node_g


def governed_registry(fleet, pending) -> MetricsRegistry:
    registry = MetricsRegistry()
    registry.apply_series_budgets({NODE_FAMILY: NODE_BUDGET})
    emit_fleet(registry, fleet, pending)
    return registry


def make_trace(trace_id: str, duration: float, status: str = "ok") -> Trace:
    root = Span(name="pod.journey", trace_id=trace_id, span_id=f"{trace_id}-root",
                parent_id=None, duration_s=duration, status=status)
    return Trace(trace_id=trace_id, spans=[root])


def drive_retention(n_traces: int) -> dict:
    """Mostly boring journeys, every 53rd slow, every 101st an error."""
    store = TraceStore(capacity=256, retention=RetentionPolicy(
        tail_capacity=64, boring_sample_n=8, slow_thresholds=SLOW_THRESHOLDS))
    for i in range(n_traces):
        if i % 101 == 0:
            store.add(make_trace(f"t{i:06d}", 0.1, status="error"))
        elif i % 53 == 0:
            store.add(make_trace(f"t{i:06d}", 2.0))
        else:
            store.add(make_trace(f"t{i:06d}", 0.1))
    return store.retention_stats()


def _p50_ms(fn, repeats: int) -> float:
    durations = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        durations.append(time.perf_counter() - t0)
    return round(statistics.median(durations) * 1e3, 3)


def _touch(node_gauge, fleet, frame: int) -> None:
    """Set a rotating window of node series: a quiet interval's writes."""
    n = min(TOUCHED_PER_FRAME, len(fleet))
    for j in range(n):
        name, _, used = fleet[(frame * n + j) % len(fleet)]
        node_gauge.labels(node=name, state="used").set(float(used + frame))


def run_config(n_nodes: int, n_pods: int, repeats: int):
    """(report row, timing row) of one size."""
    limit_ms = CYCLE_SECONDS * BUDGET_FRACTION * 1e3
    t0 = time.perf_counter()
    store = seed_store(n_nodes, n_pods)
    fleet, pending = fleet_from_store(store)
    seed_s = time.perf_counter() - t0
    del store

    ungoverned = MetricsRegistry()
    emit_fleet(ungoverned, fleet, pending)
    ungoverned_active = sum(f["exact"] + f["overflow"]
                            for f in ungoverned.series_report().values())
    ungoverned_render = ungoverned.render()
    off_p50 = _p50_ms(ungoverned.render, repeats)
    del ungoverned

    # built twice from nothing: the governed exposition is a function of
    # the series set
    governed = governed_registry(fleet, pending)
    twin_render = governed_registry(fleet, pending).render()
    governed_render = governed.render()
    report = governed.series_report()
    node_fam = report[NODE_FAMILY]
    governed_active = sum(f["exact"] + f["overflow"] for f in report.values())
    on_p50 = _p50_ms(governed.render, repeats)

    cursor = governed.cursor()
    cursor.collect()  # the prime: a whole snapshot
    node_gauge = governed.gauge(NODE_FAMILY)
    snap_durations = []
    for frame in range(repeats):
        _touch(node_gauge, fleet, frame)
        t1 = time.perf_counter()
        changed, _ = cursor.collect()
        snap_durations.append(time.perf_counter() - t1)
    snapshot_p50 = round(statistics.median(snap_durations) * 1e3, 3)
    cursor.close()

    virtual_now = [1000.0]

    def clock():
        virtual_now[0] += CYCLE_SECONDS
        return virtual_now[0]

    timeline = TimelineStore(clock=clock, vitals=False, registry=governed,
                             sizes=SizeRegistry(), watchdog=WedgeWatchdog())
    timeline.sample_once()  # primes its cursor
    sample_durations = []
    for frame in range(repeats):
        _touch(node_gauge, fleet, frame + repeats)
        t1 = time.perf_counter()
        timeline.sample_once()
        sample_durations.append(time.perf_counter() - t1)
    sample_p50 = round(statistics.median(sample_durations) * 1e3, 3)
    timeline.close()

    retention = drive_retention(max(202, min(10_000, n_pods // 100)))
    timing = {"bench": "bench_observability_timing", "nodes": n_nodes, "pods": n_pods,
              "seed_seconds": round(seed_s, 2), "exposition_off_p50_ms": off_p50,
              "exposition_on_p50_ms": on_p50, "snapshot_p50_ms": snapshot_p50,
              "timeline_sample_p50_ms": sample_p50, "limit_ms": limit_ms}
    row = {
        "bench": "bench_observability", "nodes": n_nodes, "pods": n_pods,
        "series": {"ungoverned_active": ungoverned_active, "governed_active": governed_active,
                   "governed_exact": node_fam["exact"],
                   "governed_overflow": node_fam["overflow"], "dropped": node_fam["dropped"],
                   "node_family_budget": NODE_BUDGET},
        "exposition": {"bytes_ungoverned": len(ungoverned_render),
                       "bytes_governed": len(governed_render),
                       "governed_sha256": hashlib.sha256(governed_render.encode()).hexdigest(),
                       "byte_identical": governed_render == twin_render},
        "snapshot": {"changed_series_per_frame": len(changed),
                     "primed_series": governed_active},
        "retention": {"traces": sum(retention["seen"].values()), "seen": retention["seen"],
                      "kept": retention["kept"], "sampled_out": retention["sampled_out"],
                      "hit_rate": retention["hit_rate"]},
        "overhead": {"cycle_seconds": CYCLE_SECONDS, "budget_fraction": BUDGET_FRACTION,
                     "exposition_within_budget": on_p50 <= limit_ms,
                     "snapshot_within_budget": snapshot_p50 <= limit_ms,
                     "timeline_sample_within_budget": sample_p50 <= limit_ms},
    }
    return row, timing


def run_bench(sizes: ObservabilitySizes):
    """The report rows and the timing rows, each printed as it comes."""
    rows, timings = [], []
    for n_nodes, n_pods in sizes.configs:
        row, timing = run_config(n_nodes, n_pods, sizes.repeats)
        print(json.dumps(timing), flush=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
        timings.append(timing)
    return rows, timings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", choices=sorted(SIZES), default="card")
    args = parser.parse_args(argv)
    rows, _ = run_bench(SIZES[args.size]())
    ok = all(r["exposition"]["byte_identical"] and all(r["overhead"][k] for k in
             ("exposition_within_budget", "snapshot_within_budget",
              "timeline_sample_within_budget")) for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
