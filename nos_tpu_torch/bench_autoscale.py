"""Autoscaler bench on H100 nodes: the port's counterpart of
``bench_autoscale.py`` (the whole serving control loop on the virtual
cost clock).

    python3 -m nos_tpu_torch.bench_autoscale [--size reference|quick|card]
        [--seed N] [--duration S] [--rate RPS] [--out PATH]

A seeded diurnal workload drives one cost-model replica engine a live
replica (``slo/routing.py``); the retired requests feed one SLO engine a
model, whose burn rates and budget go to the autoscaler's signal
registry with the router's queue depth; the ModelServing reconciler
turns its verdicts into replica pods that the whole loop places on
``SimCluster`` (the scheduler's gang handshake, the MIG partitioner's
carve, the agents, the sim kubelet). The bench writes only the
ModelServings and the arrivals.

Each pair of models is the reference's two:

- ``chat`` (min 1, max 3): rides the diurnal wave, scaling up on burn
  into the peak and down on budget surplus after it;
- ``batch`` (min 0, max 1): its arrivals stop at 45% of the run, so it
  idles out and scales to zero; its GPUs pass through the autoscaler's
  cold-start grace hold, then go back to no-demand; it cold-started at
  the run's start, and the wait its backlog saw is the cold-start
  penalty.

The reconciler is stepped once a control epoch (``EPOCH_S`` virtual
seconds), the cluster stepped between epochs until it settles (every
replica bound, every plan acknowledged, no drain reservation), and a
capacity ledger integrates over the settled epoch boundaries only, as
the reference's shadow ledger does: every virtual key is a function of
the seed, and two runs give the same bytes.

Sizes (``AutoscaleSizes``):

- ``reference()``: the parity tests' translation of the reference's 4
  nodes x one v5e 2x4 board (one board is one H100): 4 MIG nodes x 1
  H100, one pair (``chat``, ``batch``) on ``7g.80gb`` replicas, 240
  virtual seconds (80 in the tests), 14 requests/s;
- ``quick()`` (the smoke's): 8 MIG nodes x 8 H100s in one pool, 16 pairs
  (``chat-<i>``, ``batch-<i>``), 16 x 14 requests/s over 80 virtual
  seconds, then 40 with no arrival for the grace holds to expire: at
  peak the pairs' maxima (3 + 1 each) ask for all 64 GPUs;
- ``card()`` (this module's): 32 nodes x 8 H100s in 4 pools, 64 pairs at
  64 x 14 requests/s over 240 virtual seconds.

The replicas' cost model takes the router's ``tick_cost_s`` and
``prefill_token_cost_s`` (the reference's 8 ms and 0.2 ms by default; a
clock calibrated on the card, ``slo/bench_serve.py --card``, otherwise).

The report keeps the reference's keys; the capacity section counts
GPU memory in GB-seconds (``total_gb_seconds``, ``busy_gb_seconds``,
``idle_gb_seconds``: under the translation the reference's chip-seconds
x 10), ``slice_profile`` names a MIG profile and ``chips_per_replica``
its memory slices (8 a ``7g.80gb``). Beside them: ``invariants``
(``SimCluster.check()`` and the ledger's ``self_check`` held at every
settled epoch), ``settle_steps``, ``grace`` (where the cold-start holds went:
``_GraceWatch``) and ``wall_s`` (the host's seconds, named so, left out
of ``virtual_digest``: the whole run and its layers, the router's drive,
the SLO evaluation, the reconciles, the cluster's settling and the
invariant checks). The module imports no torch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.modelserving import (
    MODEL_SERVING_LABEL,
    ModelServing,
    ModelServingSpec,
)
from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.autoscaler import ModelServingReconciler, SignalRegistry, policy
from nos_tpu_torch.controllers.autoscaler.controller import serving_key
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
from nos_tpu_torch.slo.driver import ModelProfile, WorkloadConfig, build_arrivals, percentiles
from nos_tpu_torch.slo.engine import SLOEngine
from nos_tpu_torch.slo.routing import PREFILL_TOKEN_COST_S, TICK_COST_S, ReplicaRouter
from nos_tpu_torch.util.resources import node_memory_slices

# one control decision an epoch (the reconciler's resync)
EPOCH_S = 5.0
# a scaled-to-zero model's wake cost (weights and warm-up): a cold-started
# replica is ready this long after its epoch
COLD_START_MODEL_COST_S = 2.0
# the cold model's arrivals stop at this share of the run
COLD_MODEL_CUTOFF_FRAC = 0.45
# the reference's settle deadline (30 wall seconds), as virtual time
SETTLE_TIMEOUT_S = 30.0

CHAT_SLOS = ("p95 ttft < 400ms", "p99 e2e < 5s")
BATCH_SLOS = ("p95 ttft < 10s",)
SLICE_PROFILE = "7g.80gb"


@dataclass(frozen=True)
class AutoscaleSizes:
    nodes: int
    gpus_per_node: int
    pools: int  # 0: no node-pool label
    pairs: int
    duration_s: float
    rate_rps: float
    # epochs past the arrivals, long enough for the cold models' grace
    # holds to expire
    tail_s: float = 0.0

    @classmethod
    def reference(cls) -> "AutoscaleSizes":
        """The reference's 4 boards as 4 one-GPU nodes, one pair."""
        return cls(nodes=4, gpus_per_node=1, pools=0, pairs=1, duration_s=240.0,
                   rate_rps=14.0)

    @classmethod
    def quick(cls) -> "AutoscaleSizes":
        """8 x 8 H100s in one pool, 16 pairs, 80 virtual seconds of
        arrivals and 40 more for the grace holds to expire."""
        return cls(nodes=8, gpus_per_node=8, pools=1, pairs=16, duration_s=80.0,
                   rate_rps=16 * 14.0, tail_s=40.0)

    @classmethod
    def card(cls) -> "AutoscaleSizes":
        """32 x 8 H100s in 4 pools, 64 pairs, 240 virtual seconds."""
        return cls(nodes=32, gpus_per_node=8, pools=4, pairs=64, duration_s=240.0,
                   rate_rps=64 * 14.0)


SIZES = {"reference": AutoscaleSizes.reference, "quick": AutoscaleSizes.quick,
         "card": AutoscaleSizes.card}


def model_names(pairs: int) -> List[tuple]:
    """(chat, batch) model names of each pair; unsuffixed for one pair."""
    if pairs == 1:
        return [("chat", "batch")]
    return [(f"chat-{i}", f"batch-{i}") for i in range(pairs)]


def _servings(pairs: int) -> List[ModelServing]:
    out = []
    for chat, batch in model_names(pairs):
        out.append(ModelServing(chat, "default", spec=ModelServingSpec(
            model=chat, slice_profile=SLICE_PROFILE, min_replicas=1, max_replicas=3,
            slos=list(CHAT_SLOS), cold_start_grace_seconds=30.0, target_queue_depth=8,
            scale_down_budget_surplus=0.5)))
        out.append(ModelServing(batch, "default", spec=ModelServingSpec(
            model=batch, slice_profile=SLICE_PROFILE, min_replicas=0, max_replicas=1,
            slos=list(BATCH_SLOS), scale_to_zero_idle_seconds=30.0,
            cold_start_grace_seconds=40.0, target_queue_depth=4)))
    return out


def _bound(store, ms: ModelServing) -> List[str]:
    key = serving_key(ms)
    return sorted(p.name for p in store.list("Pod", namespace=ms.namespace, copy=False)
                  if p.labels.get(MODEL_SERVING_LABEL) == key and p.node)


def _bound_replica_nodes(store, ms: ModelServing) -> List[str]:
    """The node of each bound replica, sorted (a node once a replica)."""
    key = serving_key(ms)
    return sorted(p.node for p in store.list("Pod", namespace=ms.namespace, copy=False)
                  if p.labels.get(MODEL_SERVING_LABEL) == key and p.node)


def _bound_nodes(store, ms: ModelServing) -> List[str]:
    key = serving_key(ms)
    return sorted({p.node for p in store.list("Pod", namespace=ms.namespace, copy=False)
                   if p.labels.get(MODEL_SERVING_LABEL) == key and p.node})


class _GraceWatch:
    """Where the cold-start grace holds went, from the settled epochs: the
    nodes each scale to zero vacated and whether each came under a hold of
    that model (one hold a vacated replica, beside any other model's on
    the node), whether the holds the nodes carry number the vacated
    replicas whose grace has not run out at every epoch (and the most at
    once), the epochs each model held slices, and the ledger's no-demand
    GB-seconds after the last hold was released (the GPUs reclaimed)."""

    def __init__(self) -> None:
        self.vacated: Dict[str, List[str]] = {}  # model serving → its replicas' nodes
        self.vacated_held = True
        self.held_epochs: Dict[str, int] = {}
        self.held_now = 0
        self.holds_match = True
        self.holds_peak = 0
        self.no_demand_at_release: Optional[float] = None

    def epoch(self, store, servings, before: Dict[str, List[str]],
              ledger: CapacityLedger, now: float) -> None:
        """``before``: each model's bound replicas' nodes (one entry a
        replica) before the epoch's reconcile at ``now``."""
        holds = {n.name: [h.holder for h in annot.grace_holds(n.annotations,
                                                                node_memory_slices(n))]
                 for n in store.list("Node", copy=False)}
        expected = 0
        for ms in servings:
            fresh = store.get("ModelServing", ms.name, ms.namespace)
            key = serving_key(ms)
            if (fresh.status.last_verdict == policy.VERDICT_SCALE_TO_ZERO
                    and before[ms.name] and not _bound_nodes(store, ms)):
                self.vacated[ms.name] = before[ms.name]
                self.vacated_held &= all(key in holds.get(n, ()) for n in before[ms.name])
            if (fresh.status.desired_replicas == 0 and ms.name in self.vacated
                    and now < fresh.status.last_transition_t
                    + fresh.spec.cold_start_grace_seconds):
                expected += len(self.vacated[ms.name])
            if any(key in h for h in holds.values()):
                self.held_epochs[ms.name] = self.held_epochs.get(ms.name, 0) + 1
        count = sum(len(h) for h in holds.values())
        self.holds_match &= count == expected
        self.holds_peak = max(self.holds_peak, count)
        held = sum(1 for h in holds.values() if h)
        if self.held_now and not held:
            self.no_demand_at_release = ledger.idle_gb_seconds["no-demand"]
        self.held_now = held

    def payload(self, ledger: CapacityLedger) -> dict:
        reclaimed = None
        if self.no_demand_at_release is not None:
            reclaimed = ledger.idle_gb_seconds["no-demand"] - self.no_demand_at_release
        return {"scaled_to_zero": sorted(self.vacated), "vacated_nodes_held": self.vacated_held,
                "held_epochs": dict(sorted(self.held_epochs.items())),
                "nodes_held_at_end": self.held_now,
                "holds_match_vacated_replicas": self.holds_match,
                "holds_peak": self.holds_peak,
                "no_demand_gb_seconds_after_release": reclaimed}


def settle_violations(store) -> List[str]:
    """Why the cluster is not settled: a pod unbound, a MIG node whose
    plan is not acknowledged or whose reported geometry differs from its
    spec, a node holding a drain reservation."""
    out = [f"pod {p.namespaced_name} unbound" for p in store.list("Pod", copy=False)
           if not p.node]
    for node in store.list("Node", copy=False):
        ann = node.annotations
        if node.labels.get(PARTITIONING_LABEL) == PARTITIONING_MIG:
            spec_plan = ann.get(annot.SPEC_PARTITIONING_PLAN, "")
            if spec_plan:
                if ann.get(annot.STATUS_PARTITIONING_PLAN, "") != spec_plan:
                    out.append(f"node {node.name} has not acknowledged plan {spec_plan}")
                else:
                    spec, status = annot.parse_node_annotations(ann)
                    if annot.spec_geometries(spec) != annot.status_geometries(status):
                        out.append(f"node {node.name} reports another geometry than "
                                   f"plan {spec_plan}")
        if RESERVED_FOR in ann:
            out.append(f"node {node.name} holds a drain reservation")
    return out


def _converge(cluster: SimCluster) -> int:
    """Step the cluster until it settles (the reference drives its threads
    to idle in wall time); the steps taken. Raises past the deadline."""
    steps = 0
    limit = int(round(SETTLE_TIMEOUT_S / 0.05))
    while True:
        violations = settle_violations(cluster.store)
        if not violations:
            return steps
        if steps >= limit:
            raise RuntimeError("cluster failed to settle: " + "; ".join(violations[:8]))
        cluster.step()
        steps += 1


def _hold(checks: Dict[str, bool], cluster: SimCluster, ledger: CapacityLedger) -> None:
    """AND the cluster's invariants and the ledger's self-check into
    ``checks``."""
    for name, ok in cluster.check().items():
        checks[name] = checks.get(name, True) and ok
    checks["capacity_ledger_consistent"] = (checks.get("capacity_ledger_consistent", True)
                                            and not ledger.self_check())


def run_bench(sizes: AutoscaleSizes, seed: int = 0, duration_s: Optional[float] = None,
              rate_rps: Optional[float] = None, tick_cost_s: float = TICK_COST_S,
              prefill_token_cost_s: float = PREFILL_TOKEN_COST_S) -> dict:
    wall0 = time.perf_counter()
    duration_s = sizes.duration_s if duration_s is None else duration_s
    rate_rps = sizes.rate_rps if rate_rps is None else rate_rps
    pairs = model_names(sizes.pairs)
    chats = {c for c, _ in pairs}
    batches = {b for _, b in pairs}
    workload = WorkloadConfig(
        seed=seed, duration_s=duration_s, rate_rps=rate_rps, diurnal_amplitude=0.6,
        diurnal_period_s=duration_s,
        models=tuple(ModelProfile(name=m, weight=w) for c, b in pairs
                     for m, w in ((c, 0.85), (b, 0.15))))
    cutoff = COLD_MODEL_CUTOFF_FRAC * duration_s
    # filtered after the draws, so every other arrival keeps its seed
    arrivals = [a for a in build_arrivals(workload) if a.model not in batches or a.t <= cutoff]
    by_model: Dict[str, list] = {m: [] for pair in pairs for m in pair}
    for a in arrivals:
        by_model[a.model].append(a)

    state = {"now": 0.0}
    signals = SignalRegistry(now_fn=lambda: state["now"])
    cluster = SimCluster()
    shadow = CapacityLedger(cluster.store, metrics=False)
    for i in range(sizes.nodes):
        pool = f"pool-{i * sizes.pools // sizes.nodes}" if sizes.pools else None
        cluster.add_mig_node(f"gpu-{i}", gpus=sizes.gpus_per_node, pool=pool)
    servings = _servings(sizes.pairs)
    for ms in servings:
        ms.spec.validate()
        cluster.store.create(ms)

    # the slow window spans half the run: the ramp's burn ages out in time
    # for the budget-surplus scale-down off-peak
    slo_engines = {ms.spec.model: SLOEngine(list(ms.spec.slos), fast_window_s=15.0,
                                            slow_window_s=duration_s / 2.0)
                   for ms in servings}
    records: Dict[str, list] = {m: [] for m in slo_engines}

    def _sink(model):
        def sink(rec):
            records[model].append(rec)
            slo_engines[model].record(rec)
        return sink

    router = ReplicaRouter(signals=signals, max_slots=4,
                           on_complete={m: _sink(m) for m in slo_engines},
                           tick_cost_s=tick_cost_s, prefill_token_cost_s=prefill_token_cost_s)
    reconciler = ModelServingReconciler(
        cluster.store,
        # half a diurnal period: scale-down probes at most twice a cycle
        AutoscalerConfig(scale_down_stable_seconds=duration_s / 2.0,
                         recent_activity_seconds=20.0),
        signals=signals)
    checks: Dict[str, bool] = {}
    settle_steps: List[int] = []
    # the host's seconds by layer
    wall = {"drive": 0.0, "slo": 0.0, "reconcile": 0.0, "settle": 0.0, "check": 0.0}

    def timed(layer: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[layer] += time.perf_counter() - t0
        return out

    def reconcile_all() -> None:
        for ms in servings:
            reconciler.reconcile(ms.name, ms.namespace)

    try:
        # warm boot: min_replicas placed before the first arrival
        timed("reconcile", reconcile_all)
        settle_steps.append(timed("settle", _converge, cluster))
        shadow.observe(0.0)
        timed("check", _hold, checks, cluster, shadow)
        for ms in servings:
            router.sync_replicas(ms.spec.model, _bound(cluster.store, ms), ready_t=0.0)

        timeline = []
        scale_events: Dict[str, int] = {}
        cold_penalties: List[float] = []
        # the warm boot is no scale event: the first transition diffs
        # against it
        prev_desired = {ms.name: cluster.store.get("ModelServing", ms.name, ms.namespace)
                        .status.desired_replicas for ms in servings}
        max_ready = {m: 0 for m in slo_engines}
        cursor = {m: 0 for m in by_model}
        peak_row = None
        peak_t = duration_s / 4.0
        final_eval: Dict[str, list] = {}

        grace = _GraceWatch()
        epochs = int(round((duration_s + sizes.tail_s) / EPOCH_S))
        for k in range(1, epochs + 1):
            t1 = k * EPOCH_S
            for model in sorted(by_model):
                stream = by_model[model]
                i = j = cursor[model]
                while j < len(stream) and stream[j].t <= t1:
                    j += 1
                timed("drive", router.drive, model, stream[i:j], t1)
                cursor[model] = j
            for model in sorted(slo_engines):
                slos = timed("slo", slo_engines[model].evaluate, t1)["slos"]
                signals.update(
                    model,
                    burn_fast=max((s["fast"]["burn_rate"] for s in slos), default=0.0),
                    burn_slow=max((s["slow"]["burn_rate"] for s in slos), default=0.0),
                    error_budget_remaining=min((s["error_budget_remaining"] for s in slos),
                                               default=1.0))
                final_eval[model] = slos
            state["now"] = t1
            before = {ms.name: _bound_replica_nodes(cluster.store, ms) for ms in servings}
            timed("reconcile", reconcile_all)
            settle_steps.append(timed("settle", _converge, cluster))
            grace.epoch(cluster.store, servings, before, shadow, t1)

            row = {"t": round(t1, 3)}
            for ms in servings:
                fresh = cluster.store.get("ModelServing", ms.name, ms.namespace)
                model = fresh.spec.model
                bound = _bound(cluster.store, fresh)
                was_zero = not router.engines(model)
                cold = (was_zero and bound
                        and fresh.status.last_verdict == policy.VERDICT_COLD_START)
                ready_t = t1 + (COLD_START_MODEL_COST_S if cold else 0.0)
                if cold:
                    cold_penalties.extend(round(ready_t - a.t, 6)
                                          for a in router.backlog.get(model, []))
                router.sync_replicas(model, bound, ready_t=ready_t)
                if fresh.status.desired_replicas != prev_desired[ms.name]:
                    verdict = fresh.status.last_verdict
                    scale_events[verdict] = scale_events.get(verdict, 0) + 1
                    prev_desired[ms.name] = fresh.status.desired_replicas
                max_ready[model] = max(max_ready[model], len(bound))
                sig = signals.get(model)
                row[model] = {"desired": fresh.status.desired_replicas, "ready": len(bound),
                              "verdict": fresh.status.last_verdict,
                              "burn_fast": round(sig.burn_fast, 4)}
            timeline.append(row)
            shadow.observe(t1)
            timed("check", _hold, checks, cluster, shadow)
            if peak_row is None and t1 >= peak_t:
                # compliance at peak asks the fast window: is the SLO met
                # right now, at the height of the wave
                peak_row = {
                    "t": round(t1, 3),
                    "by_model": {m: {"compliant": all(s["fast"]["burn_rate"] <= 1.0
                                                      for s in final_eval[m]),
                                     "burn_fast": round(max(s["fast"]["burn_rate"]
                                                            for s in final_eval[m]), 4)}
                                 for m in sorted(final_eval)},
                }

        statuses = {ms.name: cluster.store.get("ModelServing", ms.name, ms.namespace).status
                    for ms in servings}
        report = {
            "workload": {
                "seed": seed, "duration_s": duration_s, "rate_rps": rate_rps,
                "diurnal_amplitude": workload.diurnal_amplitude, "epoch_s": EPOCH_S,
                "cold_model_cutoff_s": round(cutoff, 3),
                "arrivals": {m: len(v) for m, v in by_model.items()},
            },
            "servings": {ms.name: {"model": ms.spec.model,
                                   "slice_profile": ms.spec.slice_profile,
                                   "chips_per_replica": ms.spec.chips_per_replica,
                                   "min_replicas": ms.spec.min_replicas,
                                   "max_replicas": ms.spec.max_replicas,
                                   "slos": list(ms.spec.slos)}
                         for ms in servings},
            "models": {m: {
                "requests_completed": len(records[m]),
                "ttft_s": percentiles([r.ttft_s for r in records[m] if r.ttft_s is not None]),
                "e2e_s": percentiles([r.e2e_s for r in records[m] if r.e2e_s is not None]),
                "queue_wait_s": percentiles([r.queue_wait_s for r in records[m]
                                             if r.queue_wait_s is not None]),
                "slo": [{"spec": s["spec"], "compliant": s["compliant"],
                         "burn_fast": round(s["fast"]["burn_rate"], 4),
                         "burn_slow": round(s["slow"]["burn_rate"], 4),
                         "error_budget_remaining": s["error_budget_remaining"]}
                        for s in final_eval[m]],
            } for m in sorted(records)},
            "timeline": timeline,
            "scale_events": scale_events,
            "cold_start": {"count": sum(st.cold_starts for st in statuses.values()),
                           "ttft_penalty_s": percentiles(cold_penalties)},
            "peak": {"slos_compliant": all(v["compliant"]
                                           for v in peak_row["by_model"].values()),
                     **peak_row},
            "replicas": {"max_ready": max_ready,
                         "final": {ms.spec.model: len(_bound(cluster.store, ms))
                                   for ms in servings}},
            "capacity": {
                "total_gb_seconds": round(shadow.total_gb_seconds, 3),
                "busy_gb_seconds": round(shadow.busy_gb_seconds, 3),
                "idle_gb_seconds": {b: round(v, 3) for b, v in shadow.idle_gb_seconds.items()},
            },
            "grace": grace.payload(shadow),
            "sizes": asdict(sizes),
            "clock": {"tick_cost_s": tick_cost_s, "prefill_token_cost_s": prefill_token_cost_s},
            "settle_steps": {"epochs": len(settle_steps), "max": max(settle_steps),
                             "total": sum(settle_steps)},
            "invariants": checks,
            "invariants_hold": all(checks.values()),
        }
        report["wall_s"] = {"total": time.perf_counter() - wall0, **wall}
        return report
    finally:
        cluster.close()


# ``virtual_digest`` of ``run_bench(AutoscaleSizes.reference(), duration_s=80.0)``
# on the reference's costs: the CPU tests and the smoke hold it
REFERENCE_80S_DIGEST = "058c2932d426160e6a83b3ff35087b94314541e758dbf8b5dc75a625c099276b"


def virtual_digest(report: dict) -> str:
    """sha256 of the report's virtual keys (all but ``wall_s``)."""
    body = {k: v for k, v in report.items() if k != "wall_s"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", choices=sorted(SIZES), default="card")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--duration", type=float, default=None,
                        help="virtual seconds of arrivals (the size's by default)")
    parser.add_argument("--rate", type=float, default=None,
                        help="mean arrival rate, requests a virtual second")
    parser.add_argument("--tick-cost-s", type=float, default=TICK_COST_S)
    parser.add_argument("--prefill-token-cost-s", type=float, default=PREFILL_TOKEN_COST_S)
    parser.add_argument("--out", default="", help="write the JSON report here")
    args = parser.parse_args(argv)
    report = run_bench(SIZES[args.size](), seed=args.seed, duration_s=args.duration,
                       rate_rps=args.rate, tick_cost_s=args.tick_cost_s,
                       prefill_token_cost_s=args.prefill_token_cost_s)
    report["virtual_digest"] = virtual_digest(report)
    body = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    print(body)
    return 0 if report["invariants_hold"] else 1


if __name__ == "__main__":
    sys.exit(main())
