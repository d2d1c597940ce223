"""What the flight recorder and the auditor cost the threaded suite.

Runs the threaded suite of ``chip_smoke.py``'s observability phase
(``cmd/cluster.py:build_cluster``: COMPONENTS_MIG_NODES MIG nodes of 8
H100s in two node pools, COMPONENTS_MPS_NODES MPS nodes of 8,
COMPONENTS_MIX's 240 pods in a seeded order, team-a's quota below its
demand so it borrows team-b's) once, from the checkout at ``--root``,
and prints one JSON line prefixed ``RECORD_OVERHEAD``: the wall seconds
from the first pod's creation to every pod Running, to the suite idle,
the plans processed and applied (MIG and MPS), the store lock's
contended acquisitions and blocked seconds
(``nos_tpu_store_lock_contention_total`` and
``nos_tpu_store_lock_wait_seconds_total``), and with ``--recorded`` the
records, the scheduler cycles and the audits run. ``--recorded`` attaches a ``FlightRecorder``
before the first node and audits every plan (``auditSampleRate`` 1.0);
without it the suite runs as a deployment with neither. ``--root`` may
name a checkout of an older commit: the plain run uses only the
builders' and the store's long-standing names.

    python3 tools/record_overhead.py --root . [--recorded]

Host-side figures: run it on the card's machine with the card named
beside them, one process a run, two checkouts compared in one call.
"""
import argparse
import json
import os
import random
import sys
import time


def pod_gb(spec) -> int:
    return int(spec.get("mig", spec.get("mps", "")).rsplit(".", 1)[-1][:-2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=".", help="the checkout to import")
    parser.add_argument("--recorded", action="store_true",
                        help="attach a flight recorder and audit every plan")
    parser.add_argument("--deadline", type=float, default=60.0)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import chip_smoke as cs
    from nos_tpu_torch.api.config import GpuPartitionerConfig, SchedulerConfig
    from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
    from nos_tpu_torch.api.v1alpha1.elasticquota import ElasticQuota
    from nos_tpu_torch.cmd.cluster import build_cluster
    from nos_tpu_torch.cmd.run import seed_node, seed_pod
    from nos_tpu_torch.kube.store import PodPhase
    from nos_tpu_torch.util import metrics

    rng = random.Random(cs.COMPONENTS_SEED)
    nodes = ([{"name": f"mig-{i:02d}", "partitioning": "mig",
               "nodepool": "pool-a" if i < cs.COMPONENTS_MIG_NODES // 2 else "pool-b"}
              for i in range(cs.COMPONENTS_MIG_NODES)]
             + [{"name": f"mps-{i}", "partitioning": "mps"}
                for i in range(cs.COMPONENTS_MPS_NODES)])
    pods = [{"name": f"{kind}-{what.replace('.', '-')}-{i}", "namespace": ns, kind: what}
            for ns, kind, what, n in cs.COMPONENTS_MIX for i in range(n)]
    rng.shuffle(pods)
    demand = {}
    for spec in pods:
        demand[spec["namespace"]] = demand.get(spec["namespace"], 0) + pod_gb(spec)
    mem = RESOURCE_GPU_MEMORY
    quotas = [ElasticQuota("quota", "team-a", {mem: int(demand["team-a"] * 0.8)},
                           {mem: int(demand["team-a"] * 1.2)}),
              ElasticQuota("quota", "team-b", {mem: int(demand["team-b"] * 1.5)})]

    partitioner = dict(batch_window_timeout_seconds=1.0, batch_window_idle_seconds=0.05)
    extra, flight = {}, None
    if args.recorded:
        from nos_tpu_torch.record import FlightRecorder

        partitioner["audit_sample_rate"] = 1.0
        flight = extra["flight_recorder"] = FlightRecorder(capacity=200_000)
    cluster = build_cluster(partitioner_config=GpuPartitionerConfig(**partitioner),
                            scheduler_config=SchedulerConfig(retry_seconds=0.2), **extra)
    if flight is not None:
        flight.attach(cluster.store)
    contention0 = metrics.STORE_LOCK_CONTENTION.value
    wait0 = metrics.STORE_LOCK_WAIT.value
    out = {"root": os.path.basename(root), "recorded": args.recorded, "pods": len(pods),
           "nodes": len(nodes)}
    t0 = time.perf_counter()
    try:
        for spec in nodes:
            cluster.add_node(seed_node(spec))
        for quota in quotas:
            cluster.store.create(quota)
        cluster.start()
        t1 = time.perf_counter()
        for spec in pods:
            cluster.store.create(seed_pod(spec))
        running_s = None
        while time.perf_counter() - t1 < args.deadline:
            if all(p.phase == PodPhase.RUNNING for p in cluster.pods()):
                running_s = time.perf_counter() - t1
                break
            time.sleep(0.02)
        idle = cluster.wait_idle(timeout=20.0)
        out.update(running_s=running_s, idle=idle, idle_s=time.perf_counter() - t1)
    finally:
        cluster.stop()
        if flight is not None:
            flight.detach()
    mig, mps = cluster.partitioner, cluster.partitioner.mps
    out.update(
        plans_processed={"mig": mig.plans_processed, "mps": mps.plans_processed},
        plans_applied={"mig": mig.plans_applied, "mps": mps.plans_applied},
        lock_contention=metrics.STORE_LOCK_CONTENTION.value - contention0,
        lock_wait_s=metrics.STORE_LOCK_WAIT.value - wait0,
        wall_s=time.perf_counter() - t0)
    if flight is not None:
        records = flight.records()
        out.update(records=len(records),
                   cycles=sum(r["kind"] == "scheduler.cycle" for r in records),
                   audits_run=mig.auditor.audits_run,  # one auditor serves both modes
                   audit_violations=mig.auditor.violations_total)
    print("RECORD_OVERHEAD " + json.dumps(out), flush=True)
    return 0 if running_s is not None else 1


if __name__ == "__main__":
    sys.exit(main())
