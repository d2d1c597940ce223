"""Store bench on H100 nodes: the port's counterpart of ``bench_store.py``
(the shared store's hot paths at fleet size).

    python3 -m nos_tpu_torch.bench_store [--size reference|quick|card]
        [--watchers N]

Every controller reads and writes one ``NodeStore``; at 10,000 nodes and
100,000 pods its list, index, patch and fan-out costs are the control
plane's saturation profile. ``seed_store`` builds the reference's shape
in H100 terms: nodes of 8 H100s in MIG mode (``nvidia.com/gpu`` 8, the
H100 80GB product label), each pod asking for one ``nvidia.com/gpu``,
bound round-robin, every tenth an unbound pending pod, with the phase
and node indexers registered before the seeding. The verbs, one JSON row
each (the reference's keys, in its order):

- ``store_seed``: the creates;
- ``store_list``: a whole-kind list, with and without copies;
- ``store_list_by_index``: the node index (``indexed``) against a full
  scan with a per-object test (``scan``, one repeat) on the same store;
- ``store_patch``: ``patch_merge`` phase flips of sampled pods;
- ``store_watch_fanout``: W writes fanned out to N watchers, drained;
- ``store_apply_event``: recorded MODIFIED events applied verbatim.

Besides the reference's rates, each row of a repeated verb carries its
median (``p50_ms``, ``p50_lookup_ms``, ``p50_patch_ms``), and a one-batch
verb its mean per event (``mean_event_us``). Sizes (``StoreSizes``):
``reference()`` 1,000 nodes x 10,000 pods (the reference's first
configuration), ``quick()`` 100 x 1,000 with fewer repeats and writes,
``card()`` 10,000 x 100,000 and 100,000 x 1,000,000 (two repeats at a
million pods: a copying list alone takes seconds there). Wall-clock
figures go to stdout only. The module imports no torch.
"""
from __future__ import annotations

import argparse
import json
import queue
import statistics
import sys
import time
from dataclasses import dataclass
from typing import List, Tuple

from nos_tpu_torch.api.v1alpha1.constants import INDEX_POD_NODE, INDEX_POD_PHASE, SCHEDULER_NAME
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase

GPUS_PER_NODE = 8


@dataclass(frozen=True)
class StoreSizes:
    configs: Tuple[Tuple[int, int], ...]  # (nodes, pods) each
    short: bool = False  # two repeats, 200 writes, 500 events

    @classmethod
    def reference(cls) -> "StoreSizes":
        return cls(configs=((1000, 10000),))

    @classmethod
    def quick(cls) -> "StoreSizes":
        return cls(configs=((100, 1000),), short=True)

    @classmethod
    def card(cls) -> "StoreSizes":
        return cls(configs=((10000, 100000), (100000, 1000000)))


SIZES = {"reference": StoreSizes.reference, "quick": StoreSizes.quick,
         "card": StoreSizes.card}


def build_node(name: str) -> Node:
    alloc = {RESOURCE_GPU: GPUS_PER_NODE, "cpu": 8, "memory": 128}
    return Node(name, labels={GPU_PRODUCT_LABEL: H100_80GB, PARTITIONING_LABEL: PARTITIONING_MIG},
                capacity=dict(alloc), allocatable=dict(alloc))


def build_pod(name: str, node: str, phase: str) -> Pod:
    return Pod(name, "bench", node=node, phase=phase, request={RESOURCE_GPU: 1},
               scheduler_name=SCHEDULER_NAME)


def seed_store(n_nodes: int, n_pods: int) -> NodeStore:
    """Nodes, and pods bound round-robin, every tenth pending unbound."""
    store = NodeStore()
    store.add_indexer("Pod", INDEX_POD_PHASE, lambda p: [p.phase])
    store.add_indexer("Pod", INDEX_POD_NODE, lambda p: [p.node])
    for i in range(n_nodes):
        store.create(build_node(f"node-{i:05d}"))
    for i in range(n_pods):
        if i % 10 == 0:
            store.create(build_pod(f"pod-{i:06d}", "", PodPhase.PENDING))
        else:
            store.create(build_pod(f"pod-{i:06d}", f"node-{i % n_nodes:05d}", PodPhase.RUNNING))
    return store


def _time_repeats(fn, repeats: int) -> Tuple[float, List[float]]:
    durations = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        durations.append(time.perf_counter() - t0)
    return sum(durations), durations


def _row(bench: str, n_nodes: int, n_pods: int, **extra) -> dict:
    return {"bench": bench, "nodes": n_nodes, "pods": n_pods, **extra}


def bench_list(store, n_nodes, n_pods, repeats):
    rows = []
    for copy_flag in (True, False):
        total, durations = _time_repeats(lambda: store.list("Pod", copy=copy_flag), repeats)
        rows.append(_row("store_list", n_nodes, n_pods, copy=copy_flag,
                         p50_ms=round(statistics.median(durations) * 1e3, 3),
                         lists_per_sec=round(repeats / total, 1)))
    return rows


def bench_list_by_index(store, n_nodes, n_pods, repeats):
    """``indexed``: the maintained node index; ``scan``: every pod tested,
    on the same store."""
    targets = [f"node-{i:05d}" for i in range(0, n_nodes, max(1, n_nodes // 50))]

    def indexed():
        for node in targets:
            store.list_by_index("Pod", INDEX_POD_NODE, node, copy=False)

    def scan():
        for node in targets:
            [p for p in store.list("Pod", copy=False) if p.node == node]

    rows = []
    for variant, fn in (("indexed", indexed), ("scan", scan)):
        reps = repeats if variant == "indexed" else 1  # the scan is O(pods) a lookup
        total, durations = _time_repeats(fn, reps)
        lookups = reps * len(targets)
        rows.append(_row("store_list_by_index", n_nodes, n_pods, variant=variant,
                         lookups=lookups,
                         p50_lookup_ms=round(statistics.median(durations) / len(targets) * 1e3,
                                             4),
                         lookups_per_sec=round(lookups / total, 1)))
    return rows


def bench_patch(store, n_nodes, n_pods, repeats):
    sampled = [f"pod-{i:06d}" for i in range(1, min(n_pods, 2000), 7)]

    def flip(p):
        p.phase = PodPhase.RUNNING if p.phase == PodPhase.PENDING else PodPhase.PENDING

    def patch_all():
        for name in sampled:
            store.patch_merge("Pod", name, "bench", flip)

    total, durations = _time_repeats(patch_all, repeats)
    patches = repeats * len(sampled)
    return [_row("store_patch", n_nodes, n_pods, patches=patches,
                 patches_per_sec=round(patches / total, 1),
                 p50_patch_ms=round(statistics.median(durations) / len(sampled) * 1e3, 4))]


def _drain(q) -> int:
    n = 0
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return n
        n += 1


def bench_watch_fanout(store, n_nodes, n_pods, n_watchers, writes):
    queues = [store.watch({"Pod"}, name=f"bench-watcher-{i}") for i in range(n_watchers)]
    for q in queues:  # the replay of existing pods is not measured
        _drain(q)

    def bump(p):
        p.phase = p.phase  # a version bump

    t0 = time.perf_counter()
    for i in range(writes):
        store.patch_merge("Pod", f"pod-{i % n_pods:06d}", "bench", bump)
    delivered = sum(_drain(q) for q in queues)
    total = time.perf_counter() - t0
    for q in queues:
        store.stop_watch(q)
    return [_row("store_watch_fanout", n_nodes, n_pods, watchers=n_watchers, writes=writes,
                 events_delivered=delivered, events_per_sec=round(delivered / total, 1),
                 mean_event_us=round(total / max(1, delivered) * 1e6, 3))]


def bench_apply_event(store, n_nodes, n_pods, events):
    """MODIFIED snapshots of live pods applied verbatim (the copy inside
    ``apply_event`` measured with it)."""
    pods = store.list("Pod", copy=False)[:min(events, n_pods)]
    t0 = time.perf_counter()
    applied = 0
    while applied < events:
        for pod in pods:
            store.apply_event("MODIFIED", pod)
            applied += 1
            if applied >= events:
                break
    total = time.perf_counter() - t0
    return [_row("store_apply_event", n_nodes, n_pods, events=events,
                 events_per_sec=round(applied / total, 1),
                 mean_event_us=round(total / applied * 1e6, 3))]


def run_config(n_nodes: int, n_pods: int, n_watchers: int, quick: bool) -> List[dict]:
    t0 = time.perf_counter()
    store = seed_store(n_nodes, n_pods)
    seed_s = time.perf_counter() - t0
    rows = [_row("store_seed", n_nodes, n_pods, seed_seconds=round(seed_s, 2),
                 creates_per_sec=round((n_nodes + n_pods) / seed_s, 1))]
    # two repeats at a million pods, where one copying list takes seconds
    repeats = 2 if quick or n_pods >= 1_000_000 else 5
    rows += bench_list(store, n_nodes, n_pods, repeats)
    rows += bench_list_by_index(store, n_nodes, n_pods, repeats)
    rows += bench_patch(store, n_nodes, n_pods, repeats)
    rows += bench_watch_fanout(store, n_nodes, n_pods, n_watchers,
                               writes=200 if quick else 1000)
    rows += bench_apply_event(store, n_nodes, n_pods, events=500 if quick else 5000)
    return rows


# the keys that hold times, rates or their medians; every other key is a
# function of the configuration
TIMING_KEYS = frozenset({"seed_seconds", "creates_per_sec", "p50_ms", "lists_per_sec",
                         "p50_lookup_ms", "lookups_per_sec", "patches_per_sec",
                         "p50_patch_ms", "events_per_sec", "mean_event_us"})


def deterministic(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in TIMING_KEYS}


def run_bench(sizes: StoreSizes, watchers: int = 8) -> List[dict]:
    rows = []
    for n_nodes, n_pods in sizes.configs:
        for row in run_config(n_nodes, n_pods, watchers, sizes.short):
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", choices=sorted(SIZES), default="card")
    parser.add_argument("--watchers", type=int, default=8)
    args = parser.parse_args(argv)
    run_bench(SIZES[args.size](), args.watchers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
