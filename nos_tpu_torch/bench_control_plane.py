"""Control-plane bench on H100 nodes: the port's counterpart of
``bench.py``'s half 2 (``run_control_plane_bench``, ``bench.py:812-1190``).

    python3 -m nos_tpu_torch.bench_control_plane [--sizes reference|quick|card]
        [--seed N] [--out PATH]

The whole control plane runs in-process on ``SimCluster`` (the
scheduler with the quota, gang, pool-pin and drain plugins, the MIG and
MPS partitioner controllers planning incrementally, the MIG agents, the
sim kubelet, the quota controller and the multi-node expander), in five
phases, as the reference's:

1. fill: a ``3g.40gb`` and a ``4g.40gb`` job for each GPU on an empty
   fleet; the p50 of creation → Running is the schedule latency;
2. stream (the headline): jobs of mixed sizes arrive for ``stream_s``
   seconds, the backlog kept at half the fleet's GB; each finishes 2–5 s
   after its submission (the fill's jobs 0.3–1.5 s into the stream), by
   its phase turning ``Succeeded``, as the reference's do. Utilization
   is integrated over the jobs' [bind, finish) intervals in the steady
   window (its first ``RAMP_S`` left out);
3. contention: team-a floods the fleet with ``3g.40gb`` jobs worth 1.25
   x its GB (borrowing past its min), then team-b asks for its
   guaranteed half in the same jobs, which takes preempting team-a's
   over-quota jobs;
4. churn: as many ``7g.80gb`` jobs as GPUs, then a ``3g.40gb`` and a
   ``4g.40gb`` a GPU, three times, each wave submitted before the last
   one finishes, so every GPU re-carves at each turn;
5. multi-node: one ``nvidia.com/gpu`` request of one pool's GPUs (all
   GPUs at ``reference()``), which the expander turns into a gang of
   whole-GPU members; the time from its submission until every member
   runs.

What the reference's TPU terms mean on H100s (ROADMAP.md, deliberate
differences):

- Sizes: ``reference()`` is the parity tests' translation of the
  reference's 4 nodes x one v5e 2x4 board, no pool (one board is one
  H100): 4 MIG nodes x 1 H100, no pool label. ``quick()`` (the smoke):
  8 MIG nodes x 8 H100s in one pool, 64 GPUs, its stream cut from 20 to
  8 virtual seconds (each step cycles every pending pod, so the phase's
  wall time follows the stream's steps). ``card()``: 32 MIG nodes x 8
  H100s in 4 pools of 8, 256 GPUs, 20,480 GB, uncut.
- Utilization is in GPU memory: the GB-seconds of the MIG instances that
  Running pods hold (a ``7g.80gb`` 80 GB, a ``3g.40gb`` 40) over the
  fleet's GB-seconds (80 GB a GPU), where the reference counts chips.
- Job sizes, in the reference's 1, 2, 2, 4, 4, 4, 8 chips: ``1g.10gb``,
  ``2g.20gb``, ``2g.20gb``, three 40 GB jobs (each ``3g.40gb`` or
  ``4g.40gb`` at even odds: an H100 holds one ``4g.40gb``, or it and a
  ``3g.40gb``), ``7g.80gb``.
- Quotas in ``nos.nebuly.com/gpu-memory`` GB: team-a and team-b each
  min half the fleet, max all of it. The contention's jobs are all
  ``3g.40gb``, two to a GPU, as the reference's are all 2x2, two to a
  board: an H100 holds one ``4g.40gb`` only, so a team-b ``4g.40gb``
  could not take the place of a team-a ``3g.40gb`` beside another
  team-a ``4g.40gb`` (the preemptor counts a node's memory slices, not
  its GPUs' shapes).
- The multi-node job asks one pool's GPUs, not the whole cluster's:
  ``MultinodeFilter`` keeps a gang in one pool, so a 4-pool fleet is
  never one gang.
- Time: every time key is on ``SimCluster``'s virtual clock
  (``TICK_S`` a step), where the reference's are wall times of real
  controller threads; ``wait_until`` steps the cluster until its
  predicate holds or the reference's timeout passes in virtual seconds.
  Nothing reads a wall clock for a decision; each phase's ``wall_s`` is
  the host's, reported beside the keys. Two runs with one seed give the
  same virtual-clock keys.

The result (the last stdout line of ``main``, which adds the host's
CPU count and the card's name and power limit when NVML finds one)
carries the reference's
keys under their names (``utilization_pct``, ``p50_schedule_latency_ms``,
``stream_jobs_completed``, ``pods_created``, ``slice_reconfigs_per_sec``,
``plans_applied``, ``preemptions``, ``borrow_converged``,
``fair_share_restored``, ``admission_rejects``,
``multihost_gang_formed``, ``multihost_time_to_running_s``), then what
the reference logs (the per-second utilization series, the waits by
size, the idle attribution, the board reservations, divergence replans
and plan modes), a digest of the node each job first ran on, each
phase's wall seconds, the fleet, and ``SimCluster.check()`` (its quota
and gang invariants included) after each phase (``invariants``). The
accounting is pure functions of recorded times
(``event_utilization``, ``per_second_series``, ``idle_attribution``,
``waits_by_size``), so the tests hold each against a brute-force
computation. The module imports no torch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import random
import statistics
import sys
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource
from nos_tpu_torch.kube.store import NotFoundError, Pod, PodPhase
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.resources import gpu_memory_gb_in

GPU_GB = 80
# the reference's job sizes (1, 2, 2, 4, 4, 4, 8 chips); "40gb" draws
# 3g.40gb or 4g.40gb at even odds
JOB_MIX = ("1g.10gb", "2g.20gb", "2g.20gb", "40gb", "40gb", "40gb", "7g.80gb")
FORTY = ("3g.40gb", "4g.40gb")
NAMESPACES = ("bench", "team-a", "team-b")
# the reference's wait_until timeouts, virtual seconds
FILL_TIMEOUT_S = 30.0
CONTENTION_TIMEOUT_S = 30.0
CHURN_TIMEOUT_S = 15.0
MULTIHOST_TIMEOUT_S = 30.0
SETTLE_STEPS = 400
RAMP_S = 2.5  # the stream's start, left out of its utilization


@dataclass(frozen=True)
class ControlPlaneSizes:
    nodes: int
    gpus_per_node: int
    pools: int  # 0: no node-pool label
    stream_s: float = 20.0

    @classmethod
    def reference(cls) -> "ControlPlaneSizes":
        """The reference's 4 boards as 4 one-GPU nodes (the tests')."""
        return cls(nodes=4, gpus_per_node=1, pools=0)

    @classmethod
    def quick(cls) -> "ControlPlaneSizes":
        """8 nodes x 8 H100s in one pool (the smoke's), the stream cut to 8
        virtual seconds so the phase fits its wall-time budget."""
        return cls(nodes=8, gpus_per_node=8, pools=1, stream_s=8.0)

    @classmethod
    def card(cls) -> "ControlPlaneSizes":
        """32 nodes x 8 H100s in 4 pools of 8: 256 GPUs, 20,480 GB."""
        return cls(nodes=32, gpus_per_node=8, pools=4)

    @property
    def gpus(self) -> int:
        return self.nodes * self.gpus_per_node

    @property
    def fleet_gb(self) -> int:
        return self.gpus * GPU_GB

    @property
    def multihost_gpus(self) -> int:
        """One pool's GPUs (all of them without pools)."""
        return self.gpus // self.pools if self.pools else self.gpus


SIZES = {"reference": ControlPlaneSizes.reference, "quick": ControlPlaneSizes.quick,
         "card": ControlPlaneSizes.card}


# ---------------------------------------------------------------- accounting

@dataclass(frozen=True)
class Job:
    gb: int
    bound: Optional[float]  # None: never bound
    finished: Optional[float]  # None: still running at the window's end


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def busy_gb_seconds(jobs: Iterable[Job], t0: float, t1: float) -> float:
    """The GB-seconds the jobs held inside [t0, t1]: each from its bind to
    its finish (the window's end when it runs on)."""
    return sum(job.gb * _overlap(job.bound, t1 if job.finished is None else job.finished,
                                 t0, t1)
               for job in jobs if job.bound is not None)


def event_utilization(jobs: Sequence[Job], w0: float, w1: float, fleet_gb: float) -> float:
    """Percent of the fleet's GB-seconds over [w0, w1] that jobs held
    (``bench.py:1026-1037``)."""
    if w1 <= w0:
        return 0.0
    return 100.0 * busy_gb_seconds(jobs, w0, w1) / ((w1 - w0) * fleet_gb)


def per_second_series(jobs: Sequence[Job], w0: float, w1: float,
                      fleet_gb: float) -> List[float]:
    """The utilization of each whole second of [w0, w1], the last one cut
    at w1 (``bench.py:1038-1047``), unrounded."""
    out = []
    for s in range(int(w1 - w0)):
        a0, a1 = w0 + s, min(w0 + s + 1, w1)
        out.append(100.0 * busy_gb_seconds(jobs, a0, a1) / ((a1 - a0) * fleet_gb))
    return out


def idle_attribution(samples: Sequence[Tuple[float, float, float, float]], w0: float,
                     w1: float, fleet_gb: float) -> Dict[str, float]:
    """From samples (t0, t1, idle GB, pending GB) of the stream: the
    percent of the window's GB-seconds idle while demand was pending
    (scheduling and carving inefficiency), and idle with none pending
    (the submitter's starvation) (``bench.py:1066-1084``)."""
    ineff = starved = 0.0
    for t0, t1, idle, pending in samples:
        dt = _overlap(t0, t1, w0, w1)
        if dt <= 0:
            continue
        covered = min(idle, pending)
        ineff += covered * dt
        starved += (idle - covered) * dt
    denom = (w1 - w0) * fleet_gb
    if denom <= 0:
        return {"idle_with_pending_pct": 0.0, "idle_no_pending_pct": 0.0}
    return {"idle_with_pending_pct": 100.0 * ineff / denom,
            "idle_no_pending_pct": 100.0 * starved / denom}


def waits_by_size(waits: Iterable[Tuple[str, float]]) -> Dict[str, dict]:
    """(profile, creation → bind seconds) pairs → per profile: n, p50,
    max and sum (``bench.py:1048-1065``)."""
    by: Dict[str, List[float]] = {}
    for profile, wait in waits:
        by.setdefault(profile, []).append(wait)
    return {profile: {"n": len(ws), "p50_s": statistics.median(ws), "max_s": max(ws),
                      "sum_s": sum(ws)}
            for profile, ws in sorted(by.items()) for ws in [sorted(ws)]}


def profile_gb(profile: str) -> int:
    """The GB of one MIG instance of ``profile``."""
    return gpu_memory_gb_in({mig_resource(profile): 1})


def _plan_modes() -> Dict[str, float]:
    return {child._label_values["mode"]: child.value
            for child in metrics.PLAN_MODE._sorted_children()}


# ---------------------------------------------------------------- the run

class _Bench:
    """The cluster, the job records and the reference's helpers."""

    def __init__(self, sizes: ControlPlaneSizes, seed: int, incremental_planning: bool,
                 on_step: Optional[Callable[[SimCluster], None]]) -> None:
        self.sizes = sizes
        self.rng = random.Random(seed)
        self.on_step = on_step
        self.cluster = SimCluster(incremental_planning=incremental_planning)
        for i in range(sizes.nodes):
            pool = f"pool-{i * sizes.pools // sizes.nodes}" if sizes.pools else None
            self.cluster.add_mig_node(f"h100-{i:02d}", gpus=sizes.gpus_per_node, pool=pool)
        total = sizes.fleet_gb
        for ns in ("team-a", "team-b"):
            self.cluster.add_quota(ns, {RESOURCE_GPU_MEMORY: total // 2},
                                   max={RESOURCE_GPU_MEMORY: total}, name=f"eq-{ns}")
        self.created: Dict[str, float] = {}
        self.bound: Dict[str, float] = {}
        self.profile: Dict[str, str] = {}
        self.placed: Dict[str, str] = {}  # pod key → the node it first ran on
        self.count = 0

    @property
    def now(self) -> float:
        return self.cluster.now

    def step(self) -> None:
        self.cluster.step()
        if self.on_step is not None:
            self.on_step(self.cluster)

    def submit(self, request: Dict[str, int], ns: str = "bench", profile: str = "") -> str:
        self.count += 1
        name = f"job-{self.count}"
        self.cluster.store.create(Pod(name, ns, request=dict(request)))
        key = f"{ns}/{name}"
        self.created[key] = self.now
        self.profile[key] = profile
        return key

    def submit_profile(self, profile: str, ns: str = "bench") -> str:
        return self.submit({mig_resource(profile): 1}, ns, profile)

    def draw_profile(self) -> str:
        size = self.rng.choice(JOB_MIX)
        return self.rng.choice(FORTY) if size == "40gb" else size

    def pods(self) -> List[Pod]:
        return [p for ns in NAMESPACES
                for p in self.cluster.store.list("Pod", namespace=ns, copy=False)]

    @staticmethod
    def gb(pod: Pod) -> int:
        return gpu_memory_gb_in(pod.request)

    def running_gb(self, by_ns: bool = False):
        """The GB Running pods hold (per namespace); first sightings of
        Running pods stamp their bind time."""
        total, per_ns = 0, {}
        for pod in self.pods():
            if pod.phase == PodPhase.RUNNING and pod.node:
                gb = self.gb(pod)
                total += gb
                per_ns[pod.namespace] = per_ns.get(pod.namespace, 0) + gb
                if pod.namespaced_name not in self.bound:
                    self.bound[pod.namespaced_name] = self.now
                    self.placed[pod.namespaced_name] = pod.node
        return per_ns if by_ns else total

    def wait_until(self, predicate: Callable[[], bool], timeout: float) -> bool:
        """Step until ``predicate`` holds or ``timeout`` virtual seconds
        pass (the reference's ``wait_until``)."""
        deadline = self.now + timeout
        while self.now < deadline:
            if predicate():
                return True
            self.step()
        return predicate()

    def finish(self, pod: Pod) -> None:
        try:
            self.cluster.store.patch_merge("Pod", pod.name, pod.namespace,
                                           lambda p: setattr(p, "phase", PodPhase.SUCCEEDED))
        except NotFoundError:
            pass

    def finish_all_running(self) -> None:
        for pod in self.pods():
            if pod.phase == PodPhase.RUNNING:
                self.finish(pod)

    def delete_all_pods(self) -> None:
        """A hard phase boundary: no backlog leaks into the next phase."""
        for pod in self.pods():
            try:
                self.cluster.store.delete("Pod", pod.name, pod.namespace)
            except NotFoundError:
                pass

    def settle_and_check(self) -> Dict[str, bool]:
        """After a phase's pods are gone: step until idle, then the
        cluster's invariants."""
        self.cluster.run_until_idle(SETTLE_STEPS, on_step=(
            (lambda: self.on_step(self.cluster)) if self.on_step is not None else None))
        return self.cluster.check()


def run_control_plane_bench(sizes: Optional[ControlPlaneSizes] = None, seed: int = 0,
                            incremental_planning: bool = True,
                            on_step: Optional[Callable[[SimCluster], None]] = None,
                            log: Callable[[str], None] = lambda msg: None) -> dict:
    """The five phases on a fresh ``SimCluster``; the result's keys. The
    seed draws the stream's sizes and finish times; ``on_step(cluster)``
    runs after every step (an invariant watch)."""
    sizes = sizes or ControlPlaneSizes.reference()
    b = _Bench(sizes, seed, incremental_planning, on_step)
    total = sizes.fleet_gb
    wall: Dict[str, float] = {}
    invariants: Dict[str, Dict[str, bool]] = {}
    preempt_before = metrics.PREEMPTIONS.total
    reservations_before = metrics.BOARD_RESERVATIONS.value
    divergence_before = metrics.DIVERGENCE_REPLANS.value
    modes_before = _plan_modes()

    # ---- phase 1: fill an empty fleet
    t = time.perf_counter()
    fill_keys = []
    for _ in range(sizes.gpus):
        fill_keys += [b.submit_profile("3g.40gb"), b.submit_profile("4g.40gb")]
    filled = b.wait_until(lambda: b.running_gb() >= total, FILL_TIMEOUT_S)
    fill_lat = sorted(b.bound[k] - b.created[k] for k in fill_keys if k in b.bound)
    p50 = statistics.median(fill_lat) if fill_lat else float("nan")
    invariants["fill"] = b.cluster.check()
    wall["fill"] = time.perf_counter() - t
    log(f"phase1 fill: {b.running_gb()}/{total} GB running, p50 carve+schedule latency "
        f"{p50 * 1000:.0f} virtual ms over {len(fill_lat)} pods")

    # ---- phase 2: the steady stream (the headline)
    t = time.perf_counter()
    t_stream = b.now
    finish_at: Dict[str, float] = {}
    finished_at: Dict[str, float] = {}
    job_gb: Dict[str, int] = {}
    done = 0
    for pod in b.pods():
        if pod.phase == PodPhase.RUNNING:
            key = pod.namespaced_name
            finish_at[key] = t_stream + b.rng.uniform(0.3, 1.5)
            job_gb[key] = b.gb(pod)
    samples: List[Tuple[float, float, float, float]] = []
    t_prev = t_stream
    while b.now - t_stream < sizes.stream_s:
        now = b.now
        running_now = pending_now = 0
        for pod in b.pods():
            key = pod.namespaced_name
            gb = job_gb.get(key)
            if gb is None:
                gb = b.gb(pod)
            if pod.phase == PodPhase.RUNNING and pod.node:
                if key not in b.bound:
                    b.bound[key] = now
                    b.placed[key] = pod.node
                if now >= finish_at.get(key, math.inf):
                    b.finish(pod)
                    finished_at[key] = now
                    done += 1
                else:
                    running_now += gb
            elif pod.phase == PodPhase.PENDING:
                pending_now += gb
        samples.append((t_prev, now, total - running_now, pending_now))
        t_prev = now
        backlog = pending_now
        while backlog < total // 2:
            profile = b.draw_profile()
            key = b.submit_profile(profile)
            finish_at[key] = now + b.rng.uniform(2.0, 5.0)
            job_gb[key] = profile_gb(profile)
            backlog += job_gb[key]
        b.step()
    t_stream_end = b.now
    b.running_gb()  # stamp the pods bound in the last step
    w0, w1 = t_stream + RAMP_S, t_stream_end
    jobs = [Job(gb, b.bound.get(key), finished_at.get(key)) for key, gb in job_gb.items()]
    util = event_utilization(jobs, w0, w1, total)
    series = per_second_series(jobs, w0, w1, total)
    waits = waits_by_size((b.profile[k], b.bound[k] - b.created[k])
                          for k in job_gb if k in b.bound and k in b.created)
    idle = idle_attribution(samples, w0, w1, total)
    log(f"phase2 stream: {util:.1f}% of the fleet's GB over {w1 - w0:.2f} virtual s, "
        f"{done} jobs completed; per-second %: {[round(x) for x in series]}")
    b.delete_all_pods()
    invariants["stream"] = b.settle_and_check()
    wall["stream"] = time.perf_counter() - t

    # ---- phase 3: contention, borrowing, fair-share preemption
    t = time.perf_counter()
    for _ in range(round(1.25 * total / 40)):
        b.submit_profile("3g.40gb", ns="team-a")
    borrowed = b.wait_until(lambda: b.running_gb(by_ns=True).get("team-a", 0) >= total,
                            CONTENTION_TIMEOUT_S)
    borrowed_gb = b.running_gb(by_ns=True)
    for _ in range(round(0.5 * total / 40)):
        b.submit_profile("3g.40gb", ns="team-b")
    restored = b.wait_until(
        lambda: b.running_gb(by_ns=True).get("team-b", 0) >= total // 2,
        CONTENTION_TIMEOUT_S)
    by_ns = b.running_gb(by_ns=True)
    preemptions = int(metrics.PREEMPTIONS.total - preempt_before)
    log(f"phase3 contention: team-a borrow {'ok' if borrowed else 'TIMED OUT'} "
        f"{borrowed_gb}; fair share {'ok' if restored else 'TIMED OUT'} {by_ns}, "
        f"preemptions={preemptions}")
    b.delete_all_pods()
    invariants["contention"] = b.settle_and_check()
    wall["contention"] = time.perf_counter() - t

    # ---- phase 4: churn, every GPU re-carved at each turn
    t = time.perf_counter()
    controllers = b.cluster.controllers
    nodes_before = sum(c.nodes_repartitioned for c in controllers)
    plans_before = sum(c.plans_applied for c in controllers)
    t_churn = b.now
    churn_ok = True
    turns = []

    def failed_gb() -> int:
        return sum(b.gb(p) for p in b.pods() if p.phase == PodPhase.FAILED)

    for _ in range(3):
        for wave in (["7g.80gb"], ["3g.40gb", "4g.40gb"]):
            t_turn = b.now
            for _ in range(sizes.gpus):
                for profile in wave:
                    b.submit_profile(profile)
            b.finish_all_running()
            ok = b.wait_until(lambda: b.running_gb() >= total - failed_gb(), CHURN_TIMEOUT_S)
            churn_ok &= ok
            turns.append({"wave": "+".join(wave), "converged": ok,
                          "virtual_s": b.now - t_turn})
    churn_s = b.now - t_churn
    reconfigs = sum(c.nodes_repartitioned for c in controllers) - nodes_before
    churn_plans = sum(c.plans_applied for c in controllers) - plans_before
    reconfig_rate = reconfigs / churn_s if churn_s > 0 else 0.0
    log(f"phase4 churn: {churn_plans} plans / {reconfigs} node re-partitions in "
        f"{churn_s:.2f} virtual s ({reconfig_rate:.2f} a second, converged={churn_ok})")
    b.delete_all_pods()
    invariants["churn"] = b.settle_and_check()
    wall["churn"] = time.perf_counter() - t

    # ---- phase 5: one multi-node job of a pool's GPUs
    t = time.perf_counter()
    t_mh = b.now
    big = b.submit({RESOURCE_GPU: sizes.multihost_gpus}, profile="gang")
    big_name = big.split("/", 1)[1]
    members_expected = math.ceil(sizes.multihost_gpus / sizes.gpus_per_node)
    formed_at: List[float] = []

    def gang_running() -> bool:
        members = [p for p in b.cluster.store.list("Pod", namespace="bench", copy=False)
                   if p.labels.get(GANG_NAME_LABEL) == big_name]
        running = len(members) == members_expected and all(
            p.phase == PodPhase.RUNNING and p.node for p in members)
        if running and not formed_at:
            formed_at.append(b.now)
        return running

    multihost_ok = b.wait_until(gang_running, MULTIHOST_TIMEOUT_S)
    multihost_s = (formed_at[0] if formed_at else b.now) - t_mh
    member_pools = sorted({b.cluster.store.get("Node", p.node).labels.get(
        "cloud.google.com/gke-nodepool", "")
        for p in b.cluster.store.list("Pod", namespace="bench", copy=False)
        if p.labels.get(GANG_NAME_LABEL) == big_name and p.node})
    invariants["multihost"] = b.cluster.check()
    wall["multihost"] = time.perf_counter() - t
    log(f"phase5 multi-node: {sizes.multihost_gpus}-GPU request -> {members_expected}-member "
        f"gang {'RUNNING' if multihost_ok else 'TIMED OUT'} in {multihost_s:.2f} virtual s")

    modes_after = _plan_modes()
    return {
        "utilization_pct": util,
        "p50_schedule_latency_ms": p50 * 1000,
        "stream_jobs_completed": done,
        "pods_created": b.count,
        "slice_reconfigs_per_sec": reconfig_rate,
        "plans_applied": sum(c.plans_applied for c in controllers),
        "preemptions": preemptions,
        "borrow_converged": bool(borrowed),
        "fair_share_restored": bool(restored and borrowed),
        "admission_rejects": b.cluster.kubelet.admission_rejects,
        "multihost_gang_formed": bool(multihost_ok),
        "multihost_time_to_running_s": multihost_s,
        "fill_converged": bool(filled),
        "stream_window_s": w1 - w0,
        "utilization_per_second_pct": series,
        "waits_by_size": waits,
        **idle,
        "board_reservations": int(metrics.BOARD_RESERVATIONS.value - reservations_before),
        "divergence_replans": int(metrics.DIVERGENCE_REPLANS.value - divergence_before),
        "plan_modes": {mode: int(n - modes_before.get(mode, 0))
                       for mode, n in sorted(modes_after.items())
                       if n - modes_before.get(mode, 0)},
        "capacity_freed_fires": sum(c.capacity_freed_fires for c in controllers),
        "contention_gb": {"borrowed": borrowed_gb, "restored": by_ns},
        "churn_turns": turns,
        "churn_virtual_s": churn_s,
        "churn_node_repartitions": reconfigs,
        "multihost_members": members_expected,
        "multihost_pools": member_pools,
        "placements": len(b.placed),
        "placement_digest": hashlib.sha256(
            json.dumps(sorted(b.placed.items())).encode()).hexdigest(),
        "virtual_s": b.now,
        "steps": b.cluster.steps,
        "invariants": invariants,
        "invariants_hold": all(all(c.values()) for c in invariants.values()),
        "wall_s": wall,
        "incremental_planning": incremental_planning,
        "sizes": {**asdict(sizes), "gpus": sizes.gpus, "fleet_gb": total,
                  "multihost_gpus": sizes.multihost_gpus},
        "seed": seed,
    }


def virtual_keys(result: dict) -> dict:
    """The result without its wall-clock seconds: what repeats run to run."""
    return {k: v for k, v in result.items() if k != "wall_s"}


def merged_line(control_plane: dict) -> dict:
    """The line ``bench.py:main --control-plane-only`` prints: the
    utilization is the headline (``vs_baseline`` against the reference's
    90% north star), the other control-plane keys beside it."""
    util = control_plane.get("utilization_pct", 0.0)
    line = {"metric": "gpu_memory_utilization", "value": util, "unit": "%",
            "vs_baseline": util / 90.0}
    line.update((k, v) for k, v in control_plane.items() if k != "utilization_pct")
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", choices=sorted(SIZES), default="reference")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write the result's JSON line to this file")
    args = parser.parse_args(argv)
    started = time.perf_counter()
    result = run_control_plane_bench(SIZES[args.sizes](), seed=args.seed,
                                     log=lambda msg: print(msg, file=sys.stderr, flush=True))
    result["wall_s"]["total"] = time.perf_counter() - started
    # the host code's machine: its CPUs, and the card NVML finds there
    from nos_tpu_torch.partitioning.bench_planner import card

    result.update(host_cpus=os.cpu_count(), card=card())
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
