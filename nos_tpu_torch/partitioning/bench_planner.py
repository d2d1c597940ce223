"""Cold-plan timings of the planner on clusters of H100 nodes.

The cold-plan rows of ``bench_planner.py`` (the reference's ``cow``
engine, ``bench_config``), and only those: one fresh snapshot and
planner a plan, verdict cache on and off, on clusters of ``--sizes``
nodes × pending pods (by default 16x50, 64x200 and 256x400), each node
``--gpus-per-node`` H100s (8 by default). The cluster is busy and
fragmented: each GPU draws its fill state, seeded, from ``FILLS`` (in
sixteenths: 1 virgin, 1 each with one free 3g.40gb, 1g.10gb or
2g.20gb beside used instances, 5 half used with a 3g.40gb and two
1g.10gb, 7 full with a 7g.80gb; each used instance held by a running
pod). Pending pods ask for one of 1g.10gb, 2g.20gb, 3g.40gb, 4g.40gb and
7g.80gb, seeded. Demand deliberately exceeds the free supply, as in the
reference's bench, so the carve loop runs to exhaustion and pods are
left unserved; and the free slices are spread over profiles, so a pod
is tried on many nodes whose free slices do not fit it, the trials the
verdict cache answers. A row gives p50 / p95 plan milliseconds over ``--repeats``
timed plans (after one untimed), forks a second, the cache's hits and
hit rate, the pods placed and unserved, and whether the cache-on plan
equals the cache-off one (partitioning state, the node each pending pod
was placed on, and the unserved pods). The
header gives the host's CPU count, and the card's name and power limit
when NVML finds one (the planner is host code: the card is named so a
row can be matched to its machine).

The planner runs with ``--framework``: ``sim`` (the default) is the
simulation framework ``SimCluster`` plans with (``build_sim_framework``:
the vanilla filters and ``CapacityScheduling``'s PreFilter), over a
store holding the cluster's nodes and running pods and one ElasticQuota
of the bench namespace whose min, in ``nos.nebuly.com/gpu-memory``, is
the whole cluster's memory, so the quota admits every pod and the
PreFilter's arithmetic runs on every trial; ``vanilla`` is the vanilla
filters alone, without a store (the rows before the quota slice).

``--incremental`` runs the ``bench_incremental`` row instead
(``bench_planner.py:233-292``): steady-state replans over one persistent
snapshot and planner. Every GPU of the steady cluster is pinned by a
used 4g.40gb (no 7g.80gb carve can succeed) beside free 1g.10gb
instances (two, or one beside a used one: the two variants a refresh
flips between); 90% of the pending pods ask for a 7g.80gb (every carve
futile: the futility memo carries the replan), 10% for a 1g.10gb the
free pool claims each cycle. An untimed cold plan (fallback mode) builds
the memos, an untimed warm-up cycle follows, then ``--repeats`` timed
cycles each flip 5% of the nodes through ``refresh_node`` and
replan with that dirty set. Every cycle must take the incremental path
(else the row raises), and each cycle's plan is held against a full
plan of the same state on a fresh snapshot and planner
(``plan_equals_full``). The row gives the cold plan's ms, p50 / p95
replan ms, their ratio, the futility memo's hits and the verdict
cache's hit rate in the last cycle.

    python -m nos_tpu_torch.partitioning.bench_planner --quick
    python -m nos_tpu_torch.partitioning.bench_planner --sizes 64x200 --repeats 3
    python -m nos_tpu_torch.partitioning.bench_planner --framework vanilla --quick
``--plan-mode sharded`` (``bench_planner.py:191-232``, ``:302-735``)
runs the pool-sharded pipeline on the steady cluster split into
``--pools`` node pools (the node-pool label, round-robin) with every
pending pod pinned to a pool by its node selector, round-robin: a
``capacity_row`` (the cluster's capacity and free memory slices, the
utilization and the fragmentation index: 1 - the largest free slice over
the largest askable slice); then ``bench_sharded`` for each backend of
``--parallel`` (``serial``, ``thread``, ``process`` or ``all``): one
persistent snapshot and planner a pool, 5% of the nodes refreshed in
their pool's snapshot a cycle, every pool replanned, then
the merge and its checks, the whole timed (``p50_merge_ms`` alone), the
cyclic collector run between cycles outside the timed window and
reported; every timed cycle must plan incrementally. The process row
runs the controller's own call, ``PoolWorkerPool.plan_pools`` (a
bootstrap from the whole wire image, then a cycle of the refreshed nodes
and only the new or changed pending pods out, the touched nodes back
over the parent's mirror); it adds the bootstrap's milliseconds, each worker's
start-to-bootstrapped seconds, whether ``torch`` is in a worker's
``sys.modules``, the frame bytes a cycle and the start method
(``--start-method``). The thread row (``run_pool_plans``) exists here
alone, to measure that the controller is right to leave it out: the
planner is pure Python, so threads share one interpreter lock. Every row
carries the host's CPU count, which bounds the processes' gain. Then ``bench_sharded_equivalence``
(the sharded plan against the unsharded one on the same inputs:
``draw_decomposes`` and ``byte_identical``) and ``bench_warm_boot`` (a
restart that adopts the saved warm state against a cold plan, the median
of ``--repeats`` fresh worlds: the adoption's and the warm plan's
milliseconds and whether the warm plan equals the cold one byte for
byte).

    python -m nos_tpu_torch.partitioning.bench_planner --incremental --sizes 256x400
    python -m nos_tpu_torch.partitioning.bench_planner --plan-mode sharded \
        --sizes 64x200,256x400 --pools 4 --parallel all
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import random
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import RESOURCE_GPU_MEMORY, ElasticQuota
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU, MigNode
from nos_tpu_torch.gpu.node import mig_resource
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import ClusterSnapshot, MigSliceCodec, Planner, SnapshotNode
from nos_tpu_torch.partitioning.core import pools as pool_plans
from nos_tpu_torch.partitioning.core.codec import profile_size
from nos_tpu_torch.partitioning.core.partition_state import (
    node_key,
    partitioning_state_to_dict,
)
from nos_tpu_torch.partitioning.core.snapcodec import WarmStateCodec
from nos_tpu_torch.scheduler import Framework, new_framework
from nos_tpu_torch.scheduler.framework import vanilla_filter_plugins
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from nos_tpu_torch.util import metrics

DEFAULT_SIZES = "16x50,64x200,256x400"
SEED = 0
REQUEST_MIX = ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")
# a GPU's fill, (free, used), each listed as often as its share in sixteenths
FILLS = ((({}, {}),)
         + (({"3g.40gb": 1}, {"4g.40gb": 1}),)
         + (({"1g.10gb": 1}, {"2g.20gb": 1, "4g.40gb": 1}),)
         + (({"2g.20gb": 1}, {"1g.10gb": 1, "4g.40gb": 1}),)
         + (({}, {"3g.40gb": 1, "1g.10gb": 2}),) * 5
         + (({}, {"7g.80gb": 1}),) * 7)


def node_name(i: int) -> str:
    return f"h100-{i:04d}"


def build_cluster(n_nodes: int, gpus_per_node: int, seed: int) -> ClusterSnapshot:
    """A snapshot of ``n_nodes`` MIG nodes in mixed fill states, each used
    instance held by a running pod."""
    rng = random.Random(seed)
    nodes: Dict[str, SnapshotNode] = {}
    for i in range(n_nodes):
        name = node_name(i)
        free: Dict[int, Dict[str, int]] = {}
        used: Dict[int, Dict[str, int]] = {}
        for gpu in range(gpus_per_node):
            gpu_free, gpu_used = FILLS[rng.randrange(len(FILLS))]
            if gpu_free:
                free[gpu] = dict(gpu_free)
            if gpu_used:
                used[gpu] = dict(gpu_used)
        resources = {RESOURCE_GPU: gpus_per_node, "cpu": 112, "memory": 2048}
        node = Node(name, labels={GPU_PRODUCT_LABEL: H100_80GB,
                                  PARTITIONING_LABEL: PARTITIONING_MIG},
                    capacity=dict(resources), allocatable=dict(resources),
                    annotations=annot.status_from_devices(free, used))
        pods = [Pod(f"{name}-run-{gpu}-{profile}-{k}", "bench", node=name,
                    phase=PodPhase.RUNNING, request={mig_resource(profile): 1})
                for gpu, geometry in sorted(used.items())
                for profile, qty in sorted(geometry.items()) for k in range(qty)]
        mig = MigNode(name, node.labels, node.capacity, node.annotations)
        nodes[name] = SnapshotNode(partitionable=mig, node=node, pods=pods)
    return ClusterSnapshot(nodes, codec=MigSliceCodec())


def make_pending(n_pods: int, seed: int) -> List[Pod]:
    rng = random.Random(seed + 1)
    return [Pod(f"pend-{i:04d}", "bench", request={mig_resource(rng.choice(REQUEST_MIX)): 1})
            for i in range(n_pods)]


def make_framework(kind: str, snapshot: ClusterSnapshot, gpus_per_node: int) -> Framework:
    """The planner's framework: ``sim`` over a store of the snapshot's
    nodes and running pods, with an ElasticQuota of the bench namespace
    as large as the cluster; ``vanilla`` without a store."""
    if kind == "vanilla":
        return new_framework()
    if kind != "sim":
        raise ValueError(f"framework {kind!r}: sim or vanilla")
    store = NodeStore()
    for node in snapshot.get_nodes().values():
        store.create(node.node)
        for pod in node.pods:
            store.create(pod)
    total_gb = snapshot.node_count() * gpus_per_node * KNOWN_GPUS[H100_80GB].memory_gb
    store.create(ElasticQuota("bench", "bench", {RESOURCE_GPU_MEMORY: total_gb}))
    return build_sim_framework(store)


def plan_digest(snapshot: ClusterSnapshot, state, unserved) -> tuple:
    """What two plans must agree on: each node's geometry, the node each
    pending pod was placed on in the simulation, and the unserved pods
    with their reasons."""
    placed = tuple(sorted((pod.name, name) for name, node in snapshot.get_nodes().items()
                          for pod in node.pods if pod.phase == PodPhase.PENDING))
    return (tuple(sorted((name, node_key(np)) for name, np in state.items())), placed,
            tuple(sorted(unserved.items())))


def bench_config(n_nodes: int, n_pods: int, gpus_per_node: int, repeats: int,
                 cache_on: bool, seed: int = SEED, framework: str = "sim"
                 ) -> Tuple[dict, tuple]:
    """One row, and the digest of its plans (every repeat plans the same
    inputs, so one digest must hold for all of them)."""
    latencies: List[float] = []
    forks = hits = misses = 0
    digests = set()
    placed = unserved = 0
    for rep in range(repeats + 1):  # rep 0 is an untimed warm-up
        snapshot = build_cluster(n_nodes, gpus_per_node, seed)
        planner = Planner(make_framework(framework, snapshot, gpus_per_node),
                          verdict_cache_enabled=cache_on)
        pods = make_pending(n_pods, seed)
        forks_before = metrics.SNAPSHOT_FORKS.value
        started = time.perf_counter()
        state = planner.plan(snapshot, pods, pending_ages={})
        elapsed = time.perf_counter() - started
        digests.add(plan_digest(snapshot, state, planner.last_unserved))
        if rep > 0:
            latencies.append(elapsed)
            forks += int(metrics.SNAPSHOT_FORKS.value - forks_before)
            h, m, _ = planner.verdict_cache_stats()
            hits, misses = hits + h, misses + m
        unserved = len(planner.last_unserved)
        placed = n_pods - unserved
    total = sum(latencies)
    quantiles = statistics.quantiles(latencies, n=20) if len(latencies) > 1 else latencies * 2
    row = {"bench": "bench_planner", "engine": "cow", "framework": framework,
           "verdict_cache": "on" if cache_on else "off", "nodes": n_nodes,
           "gpus_per_node": gpus_per_node, "gpus": n_nodes * gpus_per_node,
           "pending_pods": n_pods, "repeats": repeats,
           "p50_plan_ms": statistics.median(latencies) * 1e3,
           "p95_plan_ms": quantiles[-1] * 1e3,
           "forks_per_sec": forks / total if total else None, "forks_total": forks,
           "pods_placed": placed, "pods_unserved": unserved,
           "deterministic": len(digests) == 1}
    if cache_on:
        eligible = hits + misses
        row.update(cache_hits=hits, cache_misses=misses,
                   cache_hit_rate=hits / eligible if eligible else None)
    return row, digests.pop()


# the steady cluster's GPU, (free, used), in its two variants
STEADY = {False: ({"1g.10gb": 2}, {"4g.40gb": 1}),
          True: ({"1g.10gb": 1}, {"4g.40gb": 1, "1g.10gb": 1})}
STEADY_MIX = ("7g.80gb",) * 9 + ("1g.10gb",)
CHURN = 0.05  # the share of the steady cluster's nodes refreshed a cycle


def pool_of(i: int, pools: int) -> str:
    """The pool of node (or pod) ``i`` when the cluster has ``pools``."""
    return f"pool-{i % pools}" if pools else ""


def build_steady_node(name: str, variant: bool, gpus_per_node: int,
                      pool: str = "") -> SnapshotNode:
    """One node of the steady cluster, every GPU in ``variant``'s state,
    each used instance held by a running pod; ``pool`` labels its node
    pool."""
    gpu_free, gpu_used = STEADY[variant]
    free = {gpu: dict(gpu_free) for gpu in range(gpus_per_node)}
    used = {gpu: dict(gpu_used) for gpu in range(gpus_per_node)}
    resources = {RESOURCE_GPU: gpus_per_node, "cpu": 112, "memory": 2048}
    node = Node(name, labels={GPU_PRODUCT_LABEL: H100_80GB,
                              PARTITIONING_LABEL: PARTITIONING_MIG,
                              **({NODEPOOL_LABEL: pool} if pool else {})},
                capacity=dict(resources), allocatable=dict(resources),
                annotations=annot.status_from_devices(free, used))
    pods = [Pod(f"{name}-run-{gpu}-{profile}-{k}", "bench", node=name, phase=PodPhase.RUNNING,
                request={mig_resource(profile): 1})
            for gpu, geometry in sorted(used.items())
            for profile, qty in sorted(geometry.items()) for k in range(qty)]
    mig = MigNode(name, node.labels, node.capacity, node.annotations)
    return SnapshotNode(partitionable=mig, node=node, pods=pods)


def build_steady_cluster(variants: Dict[str, bool], gpus_per_node: int,
                         pools: int = 0) -> ClusterSnapshot:
    """The steady cluster; with ``pools``, node ``i`` in ``pool_of(i)``."""
    return ClusterSnapshot({name: build_steady_node(name, v, gpus_per_node,
                                                    pool_of(i, pools))
                            for i, (name, v) in enumerate(sorted(variants.items()))},
                           codec=MigSliceCodec())


def make_steady_pending(n_pods: int, pools: int = 0) -> List[Pod]:
    """The steady cluster's pending pods; with ``pools``, pod ``i`` pinned
    to ``pool_of(i)`` by its node selector."""
    return [Pod(f"pend-{i:04d}", "bench",
                request={mig_resource(STEADY_MIX[i % len(STEADY_MIX)]): 1},
                node_selector={NODEPOOL_LABEL: pool_of(i, pools)} if pools else {})
            for i in range(n_pods)]


def _state_digest(state, unserved) -> tuple:
    return (tuple(sorted((name, node_key(np)) for name, np in state.items())),
            tuple(sorted(unserved.items())))


def bench_incremental(n_nodes: int, n_pods: int, gpus_per_node: int, repeats: int) -> dict:
    """The steady-state replan row (see the module's docstring)."""
    variants = {node_name(i): False for i in range(n_nodes)}
    snapshot = build_steady_cluster(variants, gpus_per_node)
    planner = Planner(new_framework())
    pods = make_steady_pending(n_pods)
    started = time.perf_counter()
    planner.plan(snapshot, pods, pending_ages={}, dirty=set(variants))
    cold_ms = (time.perf_counter() - started) * 1e3
    if planner.last_plan_mode != "fallback":
        raise RuntimeError(f"cold plan mode {planner.last_plan_mode!r}")
    k = max(1, int(n_nodes * CHURN))
    latencies: List[float] = []
    equal = True
    for cycle in range(repeats + 1):  # cycle 0 is an untimed warm-up
        dirty = set()
        for j in range(k):
            name = node_name((cycle * k + j) % n_nodes)
            variants[name] = not variants[name]
            snapshot.refresh_node(name, build_steady_node(name, variants[name], gpus_per_node))
            dirty.add(name)
        t0 = time.perf_counter()
        state = planner.plan(snapshot, pods, pending_ages={}, dirty=dirty)
        elapsed = time.perf_counter() - t0
        if planner.last_plan_mode != "incremental":
            raise RuntimeError(f"replan mode {planner.last_plan_mode!r}")
        if cycle > 0:
            latencies.append(elapsed)
        digest = _state_digest(state, planner.last_unserved)
        full = Planner(new_framework())
        full_state = full.plan(build_steady_cluster(variants, gpus_per_node), pods,
                               pending_ages={})
        equal &= digest == _state_digest(full_state, full.last_unserved)
    quantiles = statistics.quantiles(latencies, n=20) if len(latencies) > 1 else latencies * 2
    hits, misses, _ = planner.verdict_cache_stats()
    p50_ms = statistics.median(latencies) * 1e3
    return {"bench": "bench_planner_incremental", "engine": "cow", "plan_mode": "incremental",
            "nodes": n_nodes, "gpus_per_node": gpus_per_node, "gpus": n_nodes * gpus_per_node,
            "pending_pods": n_pods, "churn": CHURN, "dirty_per_cycle": k, "cycles": repeats,
            "cold_plan_ms": cold_ms, "p50_replan_ms": p50_ms,
            "p95_replan_ms": quantiles[-1] * 1e3, "replan_speedup_vs_cold": cold_ms / p50_ms,
            "futility_hits_last_cycle": planner._futility_hits,
            "cache_hit_rate_last_cycle": hits / (hits + misses) if hits + misses else None,
            "plan_equals_full": equal}


# ------------------------------------------------------------ sharded

LARGEST_SLICE = profile_size("7g.80gb")


def capacity_row(snapshot: ClusterSnapshot, n_nodes: int, n_pods: int, churn: float) -> dict:
    """The steady cluster's capacity in memory slices: capacity, free,
    the utilization, the largest free slice and the fragmentation index,
    1 - largest free slice / min(free, the largest slice one can ask
    for), 0 when nothing is free."""
    capacity = free = largest = 0.0
    for snap_node in snapshot.get_nodes().values():
        capacity += pool_plans.node_capacity(snap_node) or 0.0
        for gpu in snap_node.partitionable.gpus:
            sizes = [profile_size(p) for p, n in gpu.free.items() for _ in range(n)]
            free += sum(sizes)
            largest = max([largest] + sizes)
    askable = min(free, LARGEST_SLICE)
    return {"bench": "bench_capacity", "nodes": n_nodes, "pending_pods": n_pods,
            "churn": churn, "capacity_slices": capacity, "free_slices": free,
            "steady_state_utilization": 1 - free / capacity if capacity else None,
            "largest_free_slice": largest,
            "fragmentation_index": max(0.0, 1 - largest / askable) if askable > 0 else 0.0}


def sharded_framework() -> Framework:
    return Framework(filter_plugins=vanilla_filter_plugins())


def _sharded_world(n_nodes: int, n_pods: int, gpus_per_node: int, pools: int):
    """(variants, snapshot, pending, partition) of the pinned steady
    cluster, the partition checked to have ``pools`` pools."""
    variants = {node_name(i): False for i in range(n_nodes)}
    snapshot = build_steady_cluster(variants, gpus_per_node, pools)
    pending = make_steady_pending(n_pods, pools)
    partition = pool_plans.partition_pools(snapshot, pending)
    if len(partition.pools) != pools:
        raise RuntimeError(f"expected {pools} pools, got {partition.pools}")
    return variants, snapshot, pending, partition


def _churn(variants: Dict[str, bool], cycle: int, k: int, n_nodes: int, gpus_per_node: int,
           pools: int):
    """The cycle's refreshed nodes: name → (index, fresh snapshot node)."""
    out = {}
    for j in range(k):
        i = (cycle * k + j) % n_nodes
        name = node_name(i)
        variants[name] = not variants[name]
        out[name] = build_steady_node(name, variants[name], gpus_per_node, pool_of(i, pools))
    return out


def _quantile_row(latencies: List[float], merges: List[float], pauses: List[float]) -> dict:
    quantiles = statistics.quantiles(latencies, n=20) if len(latencies) > 1 else latencies * 2
    return {"p50_replan_ms": statistics.median(latencies) * 1e3,
            "p95_replan_ms": quantiles[-1] * 1e3,
            "p50_merge_ms": statistics.median(merges) * 1e3,
            "gc_p50_pause_ms": statistics.median(pauses) * 1e3,
            "gc_max_pause_ms": max(pauses) * 1e3}


def run_pool_plans(tasks: Dict[str, Callable[[], object]],
                   parallelism: str = "serial") -> Dict[str, object]:
    """One closure a pool: in sorted pool order (``serial``), or on a
    thread a pool (``thread``), with the cyclic collector held off until
    the join so a full collection does not land inside the pools'
    timings (``nos_tpu/partitioning/core/pools.py:run_pool_plans``)."""
    if parallelism == "thread" and len(tasks) > 1:
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with ThreadPoolExecutor(max_workers=len(tasks)) as executor:
                futures = {name: executor.submit(task) for name, task in sorted(tasks.items())}
                return {name: future.result() for name, future in futures.items()}
        finally:
            if was_enabled:
                gc.enable()
    return {name: task() for name, task in sorted(tasks.items())}


def bench_sharded(n_nodes: int, n_pods: int, gpus_per_node: int, repeats: int, pools: int,
                  churn: float = CHURN, parallelism: str = "serial",
                  start_method: str = "forkserver") -> dict:
    """Steady-state replans through the sharded pipeline (see the module's
    docstring); ``process`` runs them on worker processes."""
    if parallelism == "process":
        return bench_sharded_process(n_nodes, n_pods, gpus_per_node, repeats, pools, churn,
                                     start_method)
    variants, snapshot, pending, partition = _sharded_world(n_nodes, n_pods, gpus_per_node,
                                                            pools)
    snaps = pool_plans.split_snapshot(snapshot, partition)
    pending_of = pool_plans.split_pending(pending, partition)
    planners = {pool: Planner(sharded_framework()) for pool in partition.pools}
    capacities = pool_plans.node_capacities(snaps.values())
    ages = {p.namespaced_name: 0.0 for p in pending}

    def plan_all(dirty: Dict[str, set]):
        def task(pool):
            def run_one():
                current = snaps[pool].partitioning_state()
                return current, planners[pool].plan(snaps[pool], pending_of[pool],
                                                    pending_ages=ages, dirty=dirty[pool])
            return run_one
        return run_pool_plans({pool: task(pool) for pool in partition.pools}, parallelism)

    started = time.perf_counter()
    plan_all({pool: set(snaps[pool].get_nodes()) for pool in partition.pools})
    cold_ms = (time.perf_counter() - started) * 1e3
    k = max(1, int(n_nodes * churn))
    latencies, merges, pauses = [], [], []
    for cycle in range(repeats + 1):  # cycle 0 is an untimed warm-up
        dirty = {pool: set() for pool in partition.pools}
        for name, fresh in _churn(variants, cycle, k, n_nodes, gpus_per_node, pools).items():
            pool = partition.node_pool[name]
            snaps[pool].refresh_node(name, fresh)
            dirty[pool].add(name)
        t0 = time.perf_counter()
        outcomes = plan_all(dirty)
        t1 = time.perf_counter()
        current = {pool: out[0] for pool, out in outcomes.items()}
        desired = {pool: out[1] for pool, out in outcomes.items()}
        violations = pool_plans.check_merge_invariants(partition, current, desired, capacities)
        pool_plans.merge_pool_states(desired)
        t2 = time.perf_counter()
        if violations:
            raise RuntimeError(f"merge checks failed: {violations[:3]}")
        modes = {planner.last_plan_mode for planner in planners.values()}
        if modes != {"incremental"}:
            raise RuntimeError(f"replan modes {sorted(modes)}")
        if cycle > 0:
            latencies.append(t2 - t0)
            merges.append(t2 - t1)
        t_gc = time.perf_counter()
        gc.collect()
        pauses.append(time.perf_counter() - t_gc)
    return {"bench": "bench_planner_sharded", "plan_mode": "sharded", "nodes": n_nodes,
            "gpus_per_node": gpus_per_node, "pending_pods": n_pods, "pools": pools,
            "parallelism": parallelism, "churn": churn, "dirty_per_cycle": k,
            "cycles": repeats, "cold_plan_ms": cold_ms,
            **_quantile_row(latencies, merges, pauses), "cpus": os.cpu_count()}


def bench_sharded_process(n_nodes: int, n_pods: int, gpus_per_node: int, repeats: int,
                          pools: int, churn: float = CHURN,
                          start_method: str = "forkserver") -> dict:
    """The sharded pipeline on a worker process a pool, through the
    controller's call (``PoolWorkerPool.plan_pools``): bootstrapped from
    the whole wire image, then each cycle the refreshed nodes out and the
    touched nodes back over the parent's mirror, then the merge and its
    checks. The timed cycle runs from the first frame out to the merge;
    ``cold_plan_ms`` includes the bootstrap."""
    from nos_tpu_torch.partitioning.core.procpool import (
        PoolWorkerPool,
        framework_spec,
        planner_knobs,
    )

    variants, snapshot, pending, partition = _sharded_world(n_nodes, n_pods, gpus_per_node,
                                                            pools)
    snaps = pool_plans.split_snapshot(snapshot, partition)
    pending_of = pool_plans.split_pending(pending, partition)
    capacities = pool_plans.node_capacities(snaps.values())
    # the parent's planners, for an escalation (the row refuses one)
    planners = {pool: Planner(sharded_framework()) for pool in partition.pools}
    workers = PoolWorkerPool("mig", "MigSliceCodec", framework_spec(sharded_framework()),
                             planner_knobs(Planner(sharded_framework())),
                             cycle_timeout_seconds=600.0, bootstrap_timeout_seconds=600.0,
                             start_method=start_method, clock=lambda: 0.0)

    def plan_all(dirty: Dict[str, set], rebuilt: bool, cycle: str):
        plans = workers.plan_pools(snaps, dirty, pending_of, planners, rebuilt=rebuilt, now=0.0)
        for pool, plan in plans.items():
            if plan.backend != "process":
                raise RuntimeError(f"pool {pool}: cycle {cycle} was planned in the parent")
        return plans

    try:
        started = time.perf_counter()
        plan_all({pool: set() for pool in partition.pools}, True, "cold")
        cold_ms = (time.perf_counter() - started) * 1e3
        # the workers start together: the last ready closes the bootstrap
        bootstrap_ms = max(seconds for seconds, _ in workers.ready) * 1e3
        k = max(1, int(n_nodes * churn))
        latencies, merges, pauses, frame_bytes = [], [], [], []
        for cycle in range(repeats + 1):  # cycle 0 is an untimed warm-up
            dirty: Dict[str, set] = {pool: set() for pool in partition.pools}
            for name, fresh in _churn(variants, cycle, k, n_nodes, gpus_per_node,
                                      pools).items():
                pool = partition.node_pool[name]
                snaps[pool].refresh_node(name, fresh)
                dirty[pool].add(name)
            t0 = time.perf_counter()
            plans = plan_all(dirty, False, str(cycle))
            t1 = time.perf_counter()
            for pool, plan in plans.items():
                if plan.plan_mode != "incremental":
                    raise RuntimeError(f"pool {pool}: replan mode {plan.plan_mode!r}")
            current = {pool: plan.current for pool, plan in plans.items()}
            desired = {pool: plan.desired for pool, plan in plans.items()}
            violations = pool_plans.check_merge_invariants(partition, current, desired,
                                                           capacities)
            pool_plans.merge_pool_states(desired)
            t2 = time.perf_counter()
            if violations:
                raise RuntimeError(f"merge checks failed: {violations[:3]}")
            if cycle > 0:
                latencies.append(t2 - t0)
                merges.append(t2 - t1)
                frame_bytes.append(workers.last_frame_bytes)
            t_gc = time.perf_counter()
            gc.collect()
            pauses.append(time.perf_counter() - t_gc)
        ready = list(workers.ready)
    finally:
        workers.close()
    return {"bench": "bench_planner_sharded", "plan_mode": "sharded", "nodes": n_nodes,
            "gpus_per_node": gpus_per_node, "pending_pods": n_pods, "pools": pools,
            "parallelism": "process", "start_method": start_method, "churn": churn,
            "dirty_per_cycle": k, "cycles": repeats, "cold_plan_ms": cold_ms,
            "bootstrap_ms": bootstrap_ms, **_quantile_row(latencies, merges, pauses),
            "worker_ready_s": [seconds for seconds, _ in ready],
            "torch_in_worker": all(loaded for _, loaded in ready),
            "frame_bytes_per_cycle": statistics.median(frame_bytes), "cpus": os.cpu_count()}


def _state_bytes(state) -> str:
    return json.dumps(partitioning_state_to_dict(state), sort_keys=True)


def bench_sharded_equivalence(n_nodes: int, n_pods: int, gpus_per_node: int,
                              pools: int) -> dict:
    """The merged sharded plan against the unsharded plan of the same
    pinned steady cluster: whether the draw decomposes, and whether the
    two are byte-identical."""
    variants, snapshot, pending, partition = _sharded_world(n_nodes, n_pods, gpus_per_node,
                                                            pools)
    unsharded = Planner(sharded_framework()).plan(
        build_steady_cluster(variants, gpus_per_node, pools), list(pending), pending_ages={})
    decomposes = pool_plans.draw_decomposes(snapshot, partition, pending)
    snaps = pool_plans.split_snapshot(snapshot, partition)
    pending_of = pool_plans.split_pending(pending, partition)
    sharded = pool_plans.merge_pool_states({
        pool: Planner(sharded_framework()).plan(snaps[pool], pending_of[pool], pending_ages={})
        for pool in partition.pools})
    return {"bench": "bench_planner_sharded_equivalence", "nodes": n_nodes,
            "gpus_per_node": gpus_per_node, "pending_pods": n_pods,
            "pools": len(partition.pools), "draw_decomposes": decomposes,
            "byte_identical": _state_bytes(sharded) == _state_bytes(unsharded)}


def bench_warm_boot(n_nodes: int, n_pods: int, gpus_per_node: int, repeats: int = 3) -> dict:
    """A restart's first plan against a cold plan, the median of
    ``repeats`` fresh worlds: the cold plan, the adoption (the file read,
    every node's signature taken again) and the warm plan of the
    unmatched nodes, and whether the warm plan equals the cold one."""
    cold_s, adopt_s, warm_s = [], [], []
    identical = True
    report = None
    pending = make_steady_pending(n_pods)
    variants = {node_name(i): False for i in range(n_nodes)}
    for _ in range(repeats):
        snapshot = build_steady_cluster(variants, gpus_per_node)
        planner = Planner(sharded_framework())
        t0 = time.perf_counter()
        cold = planner.plan(snapshot, pending, pending_ages={}, dirty=set(snapshot.get_nodes()))
        cold_s.append(time.perf_counter() - t0)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "warm-state.json")
            WarmStateCodec(path).save(snapshot, planner, force=True)
            restarted = build_steady_cluster(variants, gpus_per_node)
            warm_planner = Planner(sharded_framework())
            t0 = time.perf_counter()
            report = WarmStateCodec(path).adopt(restarted, warm_planner)
            adopt_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            warm = warm_planner.plan(restarted, pending, pending_ages={},
                                     dirty=set(report.unmatched))
            warm_s.append(time.perf_counter() - t0)
        identical &= _state_bytes(warm) == _state_bytes(cold)
    cold_ms, adopt_ms = statistics.median(cold_s) * 1e3, statistics.median(adopt_s) * 1e3
    warm_ms = statistics.median(warm_s) * 1e3
    return {"bench": "bench_planner_warm_boot", "nodes": n_nodes, "gpus_per_node": gpus_per_node,
            "pending_pods": n_pods, "repeats": repeats, "cold_plan_ms": cold_ms,
            "adopt_ms": adopt_ms, "warm_plan_ms": warm_ms,
            "warm_plan_speedup_vs_cold": cold_ms / warm_ms if warm_ms else None,
            "restart_total_ms": adopt_ms + warm_ms, "nodes_matched": report.matched,
            "nodes_unmatched": len(report.unmatched), "entries_adopted": report.adopted_entries,
            "byte_identical": identical}


PARALLEL = ("serial", "thread", "process")


def run_sharded(sizes: List[Tuple[int, int]], gpus_per_node: int, repeats: int, pools: int,
                parallel: str = "all", churn: float = CHURN,
                start_method: str = "forkserver") -> List[dict]:
    """Each size's capacity row, sharded rows, equivalence and warm-boot
    rows."""
    modes = PARALLEL if parallel == "all" else (parallel,)
    rows = []
    for n_nodes, n_pods in sizes:
        snapshot = build_steady_cluster({node_name(i): False for i in range(n_nodes)},
                                        gpus_per_node, pools)
        rows.append(capacity_row(snapshot, n_nodes, n_pods, churn))
        rows += [bench_sharded(n_nodes, n_pods, gpus_per_node, repeats, pools, churn, mode,
                               start_method) for mode in modes]
        rows.append(bench_sharded_equivalence(n_nodes, n_pods, gpus_per_node, pools))
        rows.append(bench_warm_boot(n_nodes, n_pods, gpus_per_node, min(repeats, 3)))
    return rows


def card() -> Optional[dict]:
    """The card's name and power limit from NVML, or None without one."""
    try:
        from nos_tpu_torch.device.nvml import Nvml, NvmlError, NvmlUnavailableError
    except ImportError:
        return None
    try:
        with Nvml() as nv:
            if nv.device_count() == 0:
                return None
            return {"name": nv.name(0), "power_limit_w": nv.power_limit_w(0)}
    except (NvmlUnavailableError, NvmlError):
        return None


def parse_sizes(text: str) -> List[Tuple[int, int]]:
    out = []
    for part in text.split(","):
        nodes, pods = part.lower().split("x")
        out.append((int(nodes), int(pods)))
    return out


def run(sizes: List[Tuple[int, int]], gpus_per_node: int, repeats: int,
        framework: str = "sim") -> List[dict]:
    """Cache-on and cache-off rows for every size; each cache-on row says
    whether its plan equals the cache-off one."""
    rows = []
    for n_nodes, n_pods in sizes:
        on, on_digest = bench_config(n_nodes, n_pods, gpus_per_node, repeats, True,
                                     framework=framework)
        off, off_digest = bench_config(n_nodes, n_pods, gpus_per_node, repeats, False,
                                       framework=framework)
        on["plan_equals_cache_off"] = on_digest == off_digest
        rows += [on, off]
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", default=DEFAULT_SIZES, help="nodes x pending pods, ...")
    parser.add_argument("--gpus-per-node", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--quick", action="store_true", help="16x50 only, 2 repeats")
    parser.add_argument("--framework", default="sim", choices=("sim", "vanilla"),
                        help="the planner's framework (sim: with CapacityScheduling)")
    parser.add_argument("--output", default="", help="also append JSON lines to this file")
    parser.add_argument("--incremental", action="store_true",
                        help="the steady-state incremental replan row instead")
    parser.add_argument("--plan-mode", default="cold", choices=("cold", "incremental", "sharded"),
                        help="cold plans (default), incremental replans, or the sharded rows")
    parser.add_argument("--pools", type=int, default=4, help="node pools of the sharded rows")
    parser.add_argument("--parallel", default="all", choices=PARALLEL + ("all",),
                        help="the sharded rows' backends")
    parser.add_argument("--start-method", default="forkserver", choices=("forkserver", "spawn"),
                        help="how the process rows start their workers")
    args = parser.parse_args(argv)
    sizes = [(16, 50)] if args.quick else parse_sizes(args.sizes)
    repeats = 2 if args.quick else args.repeats
    header = {"bench": "bench_planner", "host_cpus": os.cpu_count(), "card": card(),
              "gpus_per_node": args.gpus_per_node}
    if args.plan_mode == "sharded":
        rows = run_sharded(sizes, args.gpus_per_node, repeats, args.pools, args.parallel,
                           start_method=args.start_method)
    elif args.incremental or args.plan_mode == "incremental":
        rows = [bench_incremental(n, p, args.gpus_per_node, repeats) for n, p in sizes]
    else:
        rows = run(sizes, args.gpus_per_node, repeats, args.framework)
    lines = [json.dumps(header)] + [json.dumps(row) for row in rows]
    print("\n".join(lines))
    if args.output:
        with open(args.output, "a") as f:
            f.write("\n".join(lines) + "\n")
    ok = all(r.get("plan_equals_cache_off", True) and r.get("deterministic", True)
             and r.get("plan_equals_full", True)
             and (r["bench"] != "bench_planner_warm_boot" or r["byte_identical"])
             for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
