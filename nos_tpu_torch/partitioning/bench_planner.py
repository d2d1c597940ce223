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
    python -m nos_tpu_torch.partitioning.bench_planner --incremental --sizes 256x400
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import RESOURCE_GPU_MEMORY, ElasticQuota
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU, MigNode
from nos_tpu_torch.gpu.node import mig_resource
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import ClusterSnapshot, MigSliceCodec, Planner, SnapshotNode
from nos_tpu_torch.partitioning.core.partition_state import node_key
from nos_tpu_torch.scheduler import Framework, new_framework
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


def build_steady_node(name: str, variant: bool, gpus_per_node: int) -> SnapshotNode:
    """One node of the steady cluster, every GPU in ``variant``'s state,
    each used instance held by a running pod."""
    gpu_free, gpu_used = STEADY[variant]
    free = {gpu: dict(gpu_free) for gpu in range(gpus_per_node)}
    used = {gpu: dict(gpu_used) for gpu in range(gpus_per_node)}
    resources = {RESOURCE_GPU: gpus_per_node, "cpu": 112, "memory": 2048}
    node = Node(name, labels={GPU_PRODUCT_LABEL: H100_80GB,
                              PARTITIONING_LABEL: PARTITIONING_MIG},
                capacity=dict(resources), allocatable=dict(resources),
                annotations=annot.status_from_devices(free, used))
    pods = [Pod(f"{name}-run-{gpu}-{profile}-{k}", "bench", node=name, phase=PodPhase.RUNNING,
                request={mig_resource(profile): 1})
            for gpu, geometry in sorted(used.items())
            for profile, qty in sorted(geometry.items()) for k in range(qty)]
    mig = MigNode(name, node.labels, node.capacity, node.annotations)
    return SnapshotNode(partitionable=mig, node=node, pods=pods)


def build_steady_cluster(variants: Dict[str, bool], gpus_per_node: int) -> ClusterSnapshot:
    return ClusterSnapshot({name: build_steady_node(name, v, gpus_per_node)
                            for name, v in sorted(variants.items())}, codec=MigSliceCodec())


def make_steady_pending(n_pods: int) -> List[Pod]:
    return [Pod(f"pend-{i:04d}", "bench",
                request={mig_resource(STEADY_MIX[i % len(STEADY_MIX)]): 1})
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
    args = parser.parse_args(argv)
    sizes = [(16, 50)] if args.quick else parse_sizes(args.sizes)
    repeats = 2 if args.quick else args.repeats
    header = {"bench": "bench_planner", "host_cpus": os.cpu_count(), "card": card(),
              "gpus_per_node": args.gpus_per_node}
    if args.incremental:
        rows = [bench_incremental(n, p, args.gpus_per_node, repeats) for n, p in sizes]
    else:
        rows = run(sizes, args.gpus_per_node, repeats, args.framework)
    lines = [json.dumps(header)] + [json.dumps(row) for row in rows]
    print("\n".join(lines))
    if args.output:
        with open(args.output, "a") as f:
            f.write("\n".join(lines) + "\n")
    ok = all(r.get("plan_equals_cache_off", True) and r.get("deterministic", True)
             and r.get("plan_equals_full", True) for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
