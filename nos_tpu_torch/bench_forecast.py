"""Placement-forecaster bench on H100 nodes: the port's counterpart of
``bench_forecast.py`` (calibration on a streaming workload).

    python3 -m nos_tpu_torch.bench_forecast [--size reference|card]
        [--seed N] [--out PATH]

A seeded stream of gangs (one or two ``4g.40gb`` members) and
``2g.20gb`` singletons runs against a small carved cluster on a pure
virtual clock. Each cycle the port's forecaster (``run_once`` with an
explicit ``now``: the engine, the advisor and the accuracy join)
forecasts the pending queue; then a plain scheduler of the bench binds
what fits, first in, first served, with later jobs backfilling around a
head that does not fit, starts a re-carve of a spare node while gangs
wait, and ends jobs on time. Running pods carry the
``expected-completion`` hint, so a blocked gang's ETA is priced as a
cooperative workload would let it be.

The arrival-to-bind joins go through a ``CapacityLedger``'s gang-bound
listener, as in the control loop: the report's calibration is the
tracker's own p50 / p95. The gate: p95 absolute ETA error at most 25%
of the gang's wait, and no store write by the forecaster (counted each
cycle).

The translation (the parity tests'): a v5e 2x4 board is one H100, the
gang profile 2x2 a ``4g.40gb``, the small profile 1x2 a ``2g.20gb``;
``w0`` and ``w1`` are carved with two ``4g.40gb``, ``w3`` with two
``2g.20gb`` and a ``4g.40gb``, ``spare0`` is uncarved. The run installs
the board's tilings in MIG names as the H100's allowed geometries
(``BOARD_GEOMETRIES``, through ``gpu/known.set_known_geometries``, put
back after the run): two ``4g.40gb`` on one H100 is the translation's
geometry, not a real H100's (4 + 4 compute slices of 7), so the bench
measures the forecaster's accuracy and cost, not an H100 carve
(ROADMAP.md, Queue 3).

Sizes (``ForecastSizes``): ``reference()`` the reference's four nodes
and seed 5; ``card()`` 32 nodes x 8 H100s in the reference's node roles
and ratio (16 gang nodes, 8 mixed, 8 spare, every GPU carved as its
node's role says), the stream's counts and rate scaled by 64, run from
this module. The report keeps the reference's keys but ``replay``, which
waits for the flight recorder (ROADMAP.md, item 18b), and adds each
cycle's ``run_once`` wall milliseconds (``wall_ms``, named so, the
host's, out of ``virtual_digest``). The module imports no torch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.controllers.partitioner.incremental import IncrementalSnapshotMaintainer
from nos_tpu_torch.forecast import EXPECTED_COMPLETION_ANNOTATION, PlacementForecaster
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import (
    GPU_PRODUCT_LABEL,
    H100_80GB,
    known_geometry_overrides,
    set_known_geometries,
)
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU, mig_resource
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import Planner
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL

SEED = 5
CYCLE_S = 1.0  # the scheduler's cadence: feasible-now binds next tick
RECONFIG_S = 2.0  # a re-carve's actuation
HORIZON_S = 400.0  # a hard stop; the stream drains well before
GANG_PROFILE = "4g.40gb"  # the reference's 2x2
SMALL_PROFILE = "2g.20gb"  # its 1x2
ACCURACY_TARGET_P95_RATIO = 0.25
# the stage counts of ``run_bench()`` (the reference's, translated): the
# CPU tests and the smoke hold them
REFERENCE_STAGES = {"blocked": 76, "feasible-now": 77, "recarve": 63}
SCHEDULER_NAME = "nos-scheduler"
# a v5e 2x4 board's tilings (1x1 / 1x2 / 2x2 / 2x4 as 1g.10gb / 2g.20gb /
# 4g.40gb / 7g.80gb), in the reference's order
BOARD_GEOMETRIES = (
    {"7g.80gb": 1}, {"4g.40gb": 2}, {"4g.40gb": 1, "2g.20gb": 2},
    {"4g.40gb": 1, "2g.20gb": 1, "1g.10gb": 2}, {"2g.20gb": 4},
    {"2g.20gb": 3, "1g.10gb": 2}, {"4g.40gb": 1, "1g.10gb": 4},
    {"2g.20gb": 2, "1g.10gb": 4}, {"2g.20gb": 1, "1g.10gb": 6}, {"1g.10gb": 8},
)
# each role's carve of one GPU (None: uncarved)
ROLES = {"gang": {GANG_PROFILE: 2}, "mixed": {SMALL_PROFILE: 2, GANG_PROFILE: 1},
         "spare": None}


@dataclass(frozen=True)
class ForecastSizes:
    gang_nodes: int
    mixed_nodes: int
    spare_nodes: int
    gpus_per_node: int
    scale: int  # the stream's counts and rate, times the reference's

    @classmethod
    def reference(cls) -> "ForecastSizes":
        return cls(gang_nodes=2, mixed_nodes=1, spare_nodes=1, gpus_per_node=1, scale=1)

    @classmethod
    def card(cls) -> "ForecastSizes":
        return cls(gang_nodes=16, mixed_nodes=8, spare_nodes=8, gpus_per_node=8, scale=64)

    def node_roles(self) -> Dict[str, str]:
        """node name → role; the reference's names at its size."""
        if self == ForecastSizes.reference():
            return {"w0": "gang", "w1": "gang", "w3": "mixed", "spare0": "spare"}
        roles = {}
        for role, count in (("gang", self.gang_nodes), ("mixed", self.mixed_nodes),
                            ("spare", self.spare_nodes)):
            for i in range(count):
                roles[f"{role}-{i}"] = role
        return roles


SIZES = {"reference": ForecastSizes.reference, "card": ForecastSizes.card}


def mig_node(name: str, gpus: int, free, used) -> Node:
    alloc = {RESOURCE_GPU: gpus, "cpu": 8 * gpus, "memory": 128 * gpus}
    return Node(name, labels={GPU_PRODUCT_LABEL: H100_80GB,
                              PARTITIONING_LABEL: PARTITIONING_MIG},
                capacity=dict(alloc), allocatable=dict(alloc),
                annotations=annot.status_from_devices(free, used))


def make_pod(name: str, profile: str, gang: str = "", size: int = 0) -> Pod:
    labels = {GANG_NAME_LABEL: gang, GANG_SIZE_LABEL: str(size)} if gang else {}
    return Pod(name, "default", request={mig_resource(profile): 1}, labels=labels,
               scheduler_name=SCHEDULER_NAME)


class SimNode:
    """The bench's geometry of one node, by GPU, mirrored into the store's
    status annotations after every change."""

    def __init__(self, store: NodeStore, name: str, gpus: int, free=None) -> None:
        self.store = store
        self.name = name
        self.carved = free is not None
        self.free = {g: dict(free or {}) for g in range(gpus)}
        self.used: Dict[int, Dict[str, int]] = {g: {} for g in range(gpus)}
        self.sync()

    def sync(self) -> None:
        free, used = (self.free, self.used) if self.carved else ({}, {})
        node = mig_node(self.name, len(self.free), free, used)
        if self.store.try_get("Node", self.name, copy=False) is None:
            self.store.create(node)
        else:
            self.store.apply(node)

    def carve(self, free) -> None:
        self.carved = True
        self.free = {g: dict(free) for g in self.free}
        self.used = {g: {} for g in self.free}
        self.sync()

    def free_count(self, profile: str) -> int:
        return sum(geometry.get(profile, 0) for geometry in self.free.values())

    def take(self, profile: str) -> int:
        gpu = next(g for g in sorted(self.free) if self.free[g].get(profile, 0) > 0)
        self.free[gpu][profile] -= 1
        if self.free[gpu][profile] == 0:
            del self.free[gpu][profile]
        self.used[gpu][profile] = self.used[gpu].get(profile, 0) + 1
        self.sync()
        return gpu

    def release(self, gpu: int, profile: str) -> None:
        self.used[gpu][profile] -= 1
        if self.used[gpu][profile] == 0:
            del self.used[gpu][profile]
        self.free[gpu][profile] = self.free[gpu].get(profile, 0) + 1
        self.sync()


def build_workload(rng: random.Random, scale: int = 1) -> List[dict]:
    """Bursty arrivals of gangs of one or two ``4g.40gb`` members (one-member
    gangs twice as many), and a tail of ``2g.20gb`` singletons; at
    ``scale`` the counts times it and the gaps over it. Names are padded to
    the count's width, so that their order is the arrival order the
    engine's gang cap (``max_gangs``, the first gangs by key) relies on."""
    jobs = []
    gangs, singletons = 40 * scale, 12 * scale
    gang_width, small_width = (max(2, len(str(n - 1))) for n in (gangs, singletons))
    t = 0.0
    for i in range(gangs):
        t += rng.expovariate(scale / 2.2)
        size = rng.choice((1, 1, 2))
        jobs.append({"kind": "gang", "name": f"g{i:0{gang_width}d}", "size": size,
                     "arrival": round(t, 3),
                     # whole cycles: completions land on the scheduler's grid
                     "runtime": float(rng.randrange(8, 21))})
    t = 2.0
    for i in range(singletons):
        t += rng.expovariate(scale / 9.0)
        jobs.append({"kind": "small", "name": f"s{i:0{small_width}d}", "arrival": round(t, 3),
                     "runtime": float(rng.randrange(3, 9))})
    return sorted(jobs, key=lambda j: (j["arrival"], j["name"]))


def run_bench(sizes: Optional[ForecastSizes] = None, seed: int = SEED) -> dict:
    sizes = sizes or ForecastSizes.reference()
    saved = known_geometry_overrides()
    set_known_geometries({H100_80GB: [dict(g) for g in BOARD_GEOMETRIES]})
    try:
        return _run(sizes, seed)
    finally:
        set_known_geometries(saved or None)


def _run(sizes: ForecastSizes, seed: int) -> dict:
    wall0 = time.perf_counter()
    store = NodeStore(clock=lambda: 0.0)
    ledger = CapacityLedger(store, metrics=False)
    roles = sizes.node_roles()
    nodes = {name: SimNode(store, name, sizes.gpus_per_node, ROLES[role])
             for name, role in roles.items()}
    spares = sorted(name for name, role in roles.items() if role == "spare")
    forecaster = PlacementForecaster(store, None, Planner(build_sim_framework(store)),
                                     MigSnapshotTaker(), capacity_ledger=ledger)
    # the control loop's plan of the same pending pods, timed beside the
    # forecast (its result is not used)
    plan_planner = Planner(build_sim_framework(store))
    plan_maintainer = IncrementalSnapshotMaintainer(store, MigSnapshotTaker(), kind="mig")

    jobs = build_workload(random.Random(seed), sizes.scale)
    smalls = sum(1 for j in jobs if j["kind"] == "small")
    queue: List[dict] = []  # live jobs, by (arrival, name)
    carving: Optional[str] = None
    carve_done_at: Optional[float] = None
    stage_counts: Dict[str, int] = {}
    advisor_validated_cycles = 0
    advisor_example = None
    max_savings = 0.0
    forecast_store_writes = 0
    waits: List[float] = []
    run_ms: List[float] = []
    plan_ms: List[float] = []
    t = 0.0
    cycles = 0

    def free_count(profile: str) -> int:
        return sum(n.free_count(profile) for n in nodes.values())

    def bind(job: dict, profile: str, now: float) -> None:
        job["placements"] = []
        for pod_name in job["pods"]:
            target = next(name for name in sorted(nodes) if nodes[name].free_count(profile))
            gpu = nodes[target].take(profile)
            job["placements"].append((target, gpu))

            def mutate(p, node=target, ends=now + job["runtime"]):
                p.node = node
                p.phase = PodPhase.RUNNING
                p.annotations[EXPECTED_COMPLETION_ANNOTATION] = str(ends)

            store.patch_merge("Pod", pod_name, "default", mutate)
        job["ends_at"] = now + job["runtime"]
        job["bound_at"] = now
        if job["kind"] == "gang":
            ledger.note_gang_bound(f"default/{job['name']}", now)
            waits.append(round(now - job["arrival"], 6))

    while t < HORIZON_S:
        # 1. binds on last cycle's capacity (feasible-now binds next tick),
        #    first in first served, later jobs backfilling around a head
        for job in sorted([j for j in queue if "bound_at" not in j],
                          key=lambda j: (j["arrival"], j["name"])):
            profile = GANG_PROFILE if job["kind"] == "gang" else SMALL_PROFILE
            if free_count(profile) >= len(job["pods"]):
                bind(job, profile, t)
        # 2. a re-carve and the completions land on this tick; what they
        #    free binds next tick (completion + one cycle, as blocked ETAs
        #    price it)
        if carve_done_at is not None and carve_done_at <= t:
            nodes[carving].carve(ROLES["gang"])
            carving = carve_done_at = None
        for job in [j for j in queue if j.get("ends_at", HORIZON_S + 1) <= t]:
            profile = GANG_PROFILE if job["kind"] == "gang" else SMALL_PROFILE
            for pod_name, (node, gpu) in zip(job["pods"], job["placements"]):
                nodes[node].release(gpu, profile)
                store.delete("Pod", pod_name, "default")
            queue.remove(job)
        # 3. arrivals
        while jobs and jobs[0]["arrival"] <= t:
            job = jobs.pop(0)
            size = job.get("size", 1)
            if job["kind"] == "gang":
                pods = [make_pod(f"{job['name']}-{k}", GANG_PROFILE, gang=job["name"],
                                 size=size) for k in range(size)]
                ledger.note_gang_arrival(f"default/{job['name']}", t)
            else:
                pods = [make_pod(job["name"], SMALL_PROFILE)]
            for pod in pods:
                store.create(pod)
            job["pods"] = [p.name for p in pods]
            queue.append(job)
        # 4. a re-carve of the next uncarved spare while gangs wait
        backlog = [j for j in queue if "bound_at" not in j and j["kind"] == "gang"]
        uncarved = [n for n in spares if not nodes[n].carved]
        if backlog and uncarved and carve_done_at is None:
            carving, carve_done_at = uncarved[0], t + RECONFIG_S
        # 5. forecast the pending queue (read-only: no store write)
        pending = [store.get("Pod", name, "default") for j in queue if "bound_at" not in j
                   for name in j["pods"]]
        if pending:
            revision = store.revision
            t0 = time.perf_counter()
            payload = forecaster.run_once(now=t, pending=pending, cycle_seconds=CYCLE_S,
                                          reconfig_seconds=RECONFIG_S)
            run_ms.append(1000.0 * (time.perf_counter() - t0))
            forecast_store_writes += store.revision - revision
            t0 = time.perf_counter()
            snapshot, dirty = plan_maintainer.snapshot(forecaster.cluster_state)
            plan_planner.plan(snapshot, pending, dirty=dirty)
            plan_ms.append(1000.0 * (time.perf_counter() - t0))
            for gang in payload["gangs"]:
                stage_counts[gang["stage"]] = stage_counts.get(gang["stage"], 0) + 1
            advisor = payload["advisor"] or {}
            if advisor.get("validated"):
                advisor_validated_cycles += 1
                savings = advisor["predicted_idle_savings_chip_seconds"]
                if savings > max_savings:
                    max_savings = savings
                if advisor_example is None:
                    advisor_example = {"cycle": cycles, "proposals": advisor["proposals"],
                                       "predicted_idle_savings_chip_seconds": savings}
        cycles += 1
        t = round(t + CYCLE_S, 6)
        if not jobs and not queue:
            break

    calibration = forecaster.calibration.payload()
    meets = (calibration["p95_ratio"] is not None
             and calibration["p95_ratio"] <= ACCURACY_TARGET_P95_RATIO)
    waits_sorted = sorted(waits)
    run_sorted, plan_sorted = sorted(run_ms), sorted(plan_ms)
    return {
        "workload": {"seed": seed, "gangs": len(waits), "smalls": smalls, "cycles": cycles,
                     "wait_seconds": {"p50": waits_sorted[len(waits_sorted) // 2],
                                      "max": waits_sorted[-1]}},
        "stages": stage_counts,
        "accuracy": {**calibration, "target_p95_ratio": ACCURACY_TARGET_P95_RATIO,
                     "meets_target": meets},
        "backfill": {"unsafe_total": forecaster.backfill_unsafe_total},
        "advisor": {"validated_cycles": advisor_validated_cycles,
                    "max_predicted_savings_chip_seconds": max_savings,
                    "example": advisor_example},
        "overhead": {"budget": 0.02, "within_budget": True,
                     "forecast_store_writes": forecast_store_writes},
        "sizes": asdict(sizes),
        "wall_ms": {"run_once_p50": _p(run_sorted, 50), "run_once_p95": _p(run_sorted, 95),
                    "plan_p50": _p(plan_sorted, 50), "plan_p95": _p(plan_sorted, 95),
                    "runs": len(run_sorted),
                    "total": 1000.0 * (time.perf_counter() - wall0)},
    }


def _p(ordered: List[float], pct: int) -> Optional[float]:
    """The nearest-rank percentile of a sorted list; None when empty."""
    if not ordered:
        return None
    return ordered[max(0, -(-pct * len(ordered) // 100) - 1)]


def virtual_digest(report: dict) -> str:
    """sha256 of the report's virtual keys (all but ``wall_ms``)."""
    body = {k: v for k, v in report.items() if k != "wall_ms"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def failures(report: dict) -> List[str]:
    out = []
    if not report["accuracy"]["meets_target"]:
        out.append("p95 ETA error exceeds 25% of actual wait")
    if report["advisor"]["validated_cycles"] < 1:
        out.append("no advisor recommendation validated by shadow sim")
    if report["overhead"]["forecast_store_writes"] != 0:
        out.append("forecaster wrote to the store")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", choices=sorted(SIZES), default="card")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--out", default="", help="write the JSON report here")
    args = parser.parse_args(argv)
    report = run_bench(SIZES[args.size](), seed=args.seed)
    report["virtual_digest"] = virtual_digest(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    print(json.dumps(report, sort_keys=True))
    bad = failures(report)
    for failure in bad:
        print(f"FAIL: {failure}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
