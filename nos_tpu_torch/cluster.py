"""SimCluster: the dynamic-partitioning loop running in-process on one store.

Counterpart of ``nos_tpu/cmd/cluster.py:44-275`` (``SimCluster``,
``build_cluster``), trimmed to one ``NodeStore`` with the quota
webhooks and the multi-node expander's admission hook, the expander
itself (a plain GPU request past one node becomes a gang; its workers
and Service), the scheduler with the reference's plugins
(``CapacityScheduling``'s quota admission, reservations and preemption,
``GangScheduling``'s Permit, the node-pool pin, the drain reservation
and the scores), the MIG and MPS partitioner controllers planning with
the simulation framework (``build_sim_framework``: the vanilla filters,
the pool pin, the drain reservation and the quota PreFilter), one
``MigAgent`` per MIG node
on a shared ``SimMigPool``, the MPS device plugin's sim and reporter per
MPS node, the sim kubelet (``sim/kubelet.py``: a bound pod is admitted
against the devices that exist, then Running) and the quota controller,
which labels running pods and writes each quota's used.

One ``Manager`` on the store (``manager``) runs the watch-fed parts, as
the reference's ``cmd/cluster.py`` and ``cmd/partitioner.py:166-177``
wire them: for each mode's ``ClusterState`` a ``state-node-<mode>`` and
a ``state-pod-<mode>`` controller, and ``sim-kubelet`` on the bound
pending pods. Each is drained where its consumer reads, on the virtual
clock: a mode's pair at the start of its partitioner's step (the
forecaster reads the MIG state as that step drained it), the kubelet at
its place in ``step()``. The scheduler, the quota controller, the
expander and the autoscaler are polled (item 18a.2 moves them). ``add_quota`` makes an ElasticQuota, or, given ``namespaces``, a
CompositeElasticQuota.

A pending pod asking for ``nvidia.com/mig-3g.40gb`` goes around the
loop: the scheduler marks it Unschedulable, the MIG controller batches
it, snapshots, plans and actuates (spec annotations), the node's agent
re-carves the GPU and acknowledges, the device plugin advertises the
instance, the scheduler binds, the kubelet admits. An MPS pod's plan is
the device plugin's config map and label instead.

Nothing here reads a wall clock: ``step()`` advances every component
once and moves the cluster's clock (the batch windows' and the
planners' aging clock) by ``TICK_S``, so a run plans the same however
fast its host is; ``run_until_idle(max_steps)`` steps until a step
changes nothing and each controller with pods it could help has just
planned without applying anything, i.e. no pending pod can be helped.
The store's clock is the cluster's, so pods' creation times, the gang
timeouts and the drain reservations are virtual too. A MIG node's
product and GPU count come from NVML when the caller passes an ``Nvml``
(the card's own identity; its instances stay on the sim pool), else
from the caller's arguments; ``pool`` puts a node in a node pool
(the ``cloud.google.com/gke-nodepool`` label), and every node carries
``kubernetes.io/hostname``. ``check()`` holds the idle cluster to the
loop's invariants, the quotas' three and the gangs' five
(``check_gangs``, which hold at every step).

``pool_sharding``, ``pool_backend`` and ``warm_state_path`` (all off by
default) go to both controllers (``PartitionerController``'s sharded
path): with a warm-state path, a directory, each mode saves to its own
file there (``warm-state-mig.json``, ``warm-state-mps.json``); the
save interval runs on the cluster's clock. ``close()`` stops the pool
workers of the process backend.

Three optional components, wired as the reference's
``nos_tpu/cmd/cluster.py:185``, ``cmd/partitioner.py:112`` and
``cmd/autoscaler.py:31`` wire theirs, each stepped on the virtual clock:
with ``capacity_ledger`` one ``CapacityLedger`` (``capacity/ledger.py``)
that the scheduler stamps gang clocks on, the MIG controller observes
after each plan, and each step observes at its end (the reference's
heartbeat), and ``check()`` holds its ``self_check``; with ``forecast``
a ``PlacementForecaster`` of the MIG nodes (its own planner and taker,
the MIG controller's synced state), notified by the MIG controller's
plans and run right after the controllers, before the agents apply a
plan and the scheduler binds (the reference's thread wakes at the plan,
while the carve is still ahead); with ``autoscaler`` (an
``AutoscalerConfig``) a ``ModelServingReconciler`` whose registry, on
the cluster's clock, callers feed through ``autoscaler.signals``, and
which decides each step.

A ``SimCluster`` records nothing: no flight recorder, no auditor and no
event recorder are wired (its digests, ``bench_control_plane``'s and
``bench_autoscale``'s, are pinned without them). A caller may set one
on a part (``cluster.mig.auditor``, ``cluster.mig.recorder``); the
threaded suite (``cmd/cluster.py``) wires all three.
"""
from __future__ import annotations

import itertools
import logging
import os
from typing import Callable, Dict, List, Optional

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.elasticquota import (
    CAPACITY_LABEL,
    CAPACITY_OVER_QUOTA,
    CompositeElasticQuota,
    ElasticQuota,
)
from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.controllers.autoscaler import ModelServingReconciler, SignalRegistry
from nos_tpu_torch.controllers.elasticquota import (
    ElasticQuotaController,
    quota_accounting,
    register_elasticquota_webhooks,
)
from nos_tpu_torch.controllers.migagent import MigAgent, build_migagent
from nos_tpu_torch.controllers.mpsagent import MpsReporter
from nos_tpu_torch.controllers.partitioner import (
    PartitionerController,
    build_sim_framework,
    could_help,
    register_multinode_admission,
)
from nos_tpu_torch.controllers.partitioner.multinode import (
    COORDINATOR_ENV,
    MULTINODE_ROLE_LABEL,
    NUM_PROCESSES_ENV,
    PROCESS_ID_ENV,
    ROLE_LEADER,
    gang_member_env,
)
from nos_tpu_torch.controllers.partitioner.node_controller import add_state_controllers
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.device.sharing import (
    DEFAULT_CONFIG_MAP,
    SharedSliceClient,
    SimSharedDevicePlugin,
    is_mps_resource,
    load_plugin_config,
)
from nos_tpu_torch.device.sim import SimDevicePlugin, SimMigClient, SimMigPool, SimPodResourcesClient
from nos_tpu_torch.forecast import PlacementForecaster
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.geometry import geometry_fits, geometry_slices
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB, KNOWN_GPUS, allowed_geometries
from nos_tpu_torch.gpu.node import (
    MPS_RESOURCE_PREFIX,
    PARTITIONING_LABEL,
    PARTITIONING_MIG,
    PARTITIONING_MPS,
    RESOURCE_GPU,
)
from nos_tpu_torch.gpu.slicing import profile_gb
from nos_tpu_torch.kube.controller import Controller, Manager
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import Actuator, ClusterState, Planner
from nos_tpu_torch.partitioning.core.codec import is_mig_resource
from nos_tpu_torch.partitioning.mig import MigNodeInitializer, MigPartitioner, MigSnapshotTaker
from nos_tpu_torch.partitioning.mps import MpsPartitioner, MpsSnapshotTaker
from nos_tpu_torch.scheduler import CapacityScheduling, Scheduler, new_framework
from nos_tpu_torch.scheduler.plugins.capacity import build_quota_infos
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL, gang_of
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from nos_tpu_torch.sim.kubelet import SIM_KUBELET_WATCH, SimKubelet, mig_demand

log = logging.getLogger("nos_tpu_torch.cluster")

# a DGX H100's host: two 56-core CPUs, 2 TiB (in GiB)
NODE_CPU = 112
NODE_MEMORY_GIB = 2048
# the batch windows of the reference's in-process cluster (build_cluster),
# and the clock's step: a batch is planned the step after its last pod
BATCH_TIMEOUT_S = 1.0
BATCH_IDLE_S = 0.05
TICK_S = 0.05
HOSTNAME_LABEL = "kubernetes.io/hostname"


def product_label(nvml_name: str) -> str:
    """NVML's product name as GPU feature discovery labels it:
    'NVIDIA H100 80GB HBM3' → 'NVIDIA-H100-80GB-HBM3'."""
    return nvml_name.strip().replace(" ", "-")


class SimCluster:
    def __init__(self, config_map_name: str = DEFAULT_CONFIG_MAP,
                 gang_timeout_seconds: float = 30.0, incremental_planning: bool = True,
                 pool_sharding: bool = False, pool_backend: str = "",
                 warm_state_path: str = "", pool_cycle_timeout_seconds: float = 5.0,
                 warm_state_save_interval_seconds: float = 30.0,
                 capacity_ledger: bool = False, forecast: bool = False,
                 autoscaler: Optional[AutoscalerConfig] = None) -> None:
        self.now = 0.0
        self.store = NodeStore(clock=self.clock)
        register_elasticquota_webhooks(self.store)
        self.expander = register_multinode_admission(self.store)
        self.steps = 0
        self.pool = SimMigPool()
        self.ledger: Optional[CapacityLedger] = (
            CapacityLedger(self.store) if capacity_ledger else None)
        self.scheduler = Scheduler(self.store, new_framework(self.store, gang_timeout_seconds),
                                   capacity_ledger=self.ledger)
        self.quotas = ElasticQuotaController(self.store)
        self.config_map_name = config_map_name
        plan_ids = itertools.count(1)

        def plan_id() -> str:
            return f"plan-{next(plan_ids)}"

        clock = self.clock

        def sharding(kind: str) -> dict:
            return {"incremental_planning": incremental_planning,
                    "pool_sharding": pool_sharding, "pool_backend": pool_backend,
                    "pool_cycle_timeout_seconds": pool_cycle_timeout_seconds,
                    "warm_state_path": (os.path.join(warm_state_path, f"warm-state-{kind}.json")
                                        if warm_state_path else ""),
                    "warm_state_save_interval_seconds": warm_state_save_interval_seconds}

        mig_partitioner = MigPartitioner(self.store)
        mig_state, mps_state = ClusterState(), ClusterState()
        mig_initializer = MigNodeInitializer(mig_partitioner, plan_id)
        # the watch-fed state of each mode, and the kubelet, drained where
        # each consumer reads
        self.manager = Manager(self.store)
        self._mig_feed = add_state_controllers(self.manager, mig_state, mig_initializer,
                                               PARTITIONING_MIG, "-mig", clock)
        self._mps_feed = add_state_controllers(self.manager, mps_state, None,
                                               PARTITIONING_MPS, "-mps", clock)
        self.kubelet = SimKubelet(self.store, self.pool.geometry)
        self.manager.add(Controller("sim-kubelet", self.store, self.kubelet.reconcile,
                                    [SIM_KUBELET_WATCH], clock=clock))
        self.forecaster: Optional[PlacementForecaster] = None
        if forecast:
            # its own planner and taker: forecast trials never touch the
            # controller's memos
            self.forecaster = PlacementForecaster(
                self.store, mig_state, Planner(build_sim_framework(self.store), clock=clock),
                MigSnapshotTaker(), kind=PARTITIONING_MIG, capacity_ledger=self.ledger)
        self.mig = PartitionerController(
            self.store, mig_state, MigSnapshotTaker(),
            Planner(build_sim_framework(self.store), clock=clock), Actuator(mig_partitioner),
            PARTITIONING_MIG,
            is_mig_resource, BATCH_TIMEOUT_S, BATCH_IDLE_S, plan_id,
            initializer=mig_initializer, clock=clock,
            capacity_ledger=self.ledger, forecaster=self.forecaster,
            state_feed=lambda: self.manager.drain(self._mig_feed),
            **sharding(PARTITIONING_MIG))
        self.mps = PartitionerController(
            self.store, mps_state, MpsSnapshotTaker(),
            Planner(build_sim_framework(self.store), clock=clock),
            Actuator(MpsPartitioner(self.store, config_map_name)),
            PARTITIONING_MPS, is_mps_resource, BATCH_TIMEOUT_S, BATCH_IDLE_S, plan_id,
            clock=clock, state_feed=lambda: self.manager.drain(self._mps_feed),
            **sharding(PARTITIONING_MPS))
        self.controllers = (self.mig, self.mps)
        self.mps_plugin = SimSharedDevicePlugin(self.store, config_map_name)
        self.agents: Dict[str, MigAgent] = {}
        self.mps_reporters: Dict[str, MpsReporter] = {}
        self.autoscaler: Optional[ModelServingReconciler] = None
        if autoscaler is not None:
            autoscaler.validate()
            self.autoscaler = ModelServingReconciler(
                self.store, autoscaler, SignalRegistry(now_fn=self.clock))

    def clock(self) -> float:
        return self.now

    def close(self) -> None:
        """Stop the controllers' pool workers."""
        for controller in self.controllers:
            controller.close()

    # ------------------------------------------------------------ nodes

    def add_mig_node(self, name: str, gpus: int = 8, product: str = H100_80GB,
                     nvml=None, pool: Optional[str] = None) -> Node:
        """A MIG node and its agent on the sim pool. With ``nvml`` (an
        ``Nvml``) the product and GPU count are NVML's; ``pool`` names its
        node pool."""
        if nvml is not None:
            product, gpus = product_label(nvml.name(0)), nvml.device_count()
        if product not in KNOWN_GPUS:
            raise ValueError(f"{name}: GPU product {product!r} is not in gpu/known.py")
        node = self._create_node(name, gpus, product, PARTITIONING_MIG, pool)
        sim = SimMigClient(self.pool, name)
        client = GpuClient(sim, SimPodResourcesClient(self.store, name, sim.get_mig_devices))
        self.agents[name] = build_migagent(self.store, name, client,
                                           SimDevicePlugin(self.store, self.pool))
        return node

    def add_mps_node(self, name: str, gpus: int = 8, product: str = H100_80GB,
                     pool: Optional[str] = None) -> Node:
        """An MPS node, its device plugin's sim and its reporter; ``pool``
        names its node pool."""
        node = self._create_node(name, gpus, product, PARTITIONING_MPS, pool)
        self.mps_reporters[name] = MpsReporter(
            self.store, SharedSliceClient(self.store, self.config_map_name), name)
        return node

    def add_quota(self, namespace: str, min: Dict[str, int],
                  max: Optional[Dict[str, int]] = None, name: str = "quota",
                  namespaces: Optional[List[str]] = None):
        """An ElasticQuota of ``namespace``; with ``namespaces``, a
        CompositeElasticQuota over them, kept in ``namespace``. The
        webhooks admit it or raise ``AdmissionError``."""
        if namespaces is not None:
            return self.store.create(CompositeElasticQuota(
                name, namespace, list(namespaces), dict(min), dict(max or {})))
        return self.store.create(ElasticQuota(name, namespace, dict(min), dict(max or {})))

    def _create_node(self, name: str, gpus: int, product: str, kind: str,
                     pool: Optional[str] = None) -> Node:
        resources = {RESOURCE_GPU: gpus, "cpu": NODE_CPU, "memory": NODE_MEMORY_GIB}
        labels = {GPU_PRODUCT_LABEL: product, PARTITIONING_LABEL: kind, HOSTNAME_LABEL: name}
        if pool:
            labels[NODEPOOL_LABEL] = pool
        return self.store.create(Node(name, labels=labels, capacity=dict(resources),
                                      allocatable=dict(resources)))

    # ------------------------------------------------------------- loop

    def step(self) -> None:
        """Every component once, in the loop's order."""
        self.now += TICK_S
        if self.autoscaler is not None:
            self.autoscaler.step()
        self.expander.step()
        for controller in self.controllers:
            controller.step()
        if self.forecaster is not None:
            # the MIG state as the MIG controller's step drained it: the
            # plan's writes are still ahead of it, as the carve is
            self.forecaster.step()
        for agent in self.agents.values():
            agent.step()
        for name, reporter in self.mps_reporters.items():
            self.mps_plugin.reconcile(name)
            reporter.reconcile()
        self.scheduler.step()
        self.manager.drain(["sim-kubelet"])
        self.quotas.step()
        if self.ledger is not None:
            self.ledger.observe(self.now)
        self.steps += 1

    def fingerprint(self) -> tuple:
        """The store's observable state."""
        nodes = tuple((n.name, tuple(sorted(n.annotations.items())),
                       tuple(sorted(n.labels.items())), tuple(sorted(n.allocatable.items())))
                      for n in self.store.list("Node", copy=False))
        pods = tuple((p.namespaced_name, p.uid, p.node, p.phase, p.unschedulable,
                      p.nominated_node, p.labels.get(CAPACITY_LABEL))
                     for p in self.store.list("Pod", copy=False))
        maps = tuple((c.name, tuple(sorted(c.data.items())))
                     for c in self.store.list("ConfigMap", copy=False))
        quotas = tuple((q.kind, q.namespace, q.name, tuple(sorted(q.used.items())))
                       for kind in ("ElasticQuota", "CompositeElasticQuota")
                       for q in self.store.list(kind, copy=False))
        return nodes, pods, maps, quotas

    def helpable(self, controller: PartitionerController) -> List[Pod]:
        """The pending pods ``controller`` could plan for."""
        return [p for p in controller.fetch_pending_pods()
                if could_help(p) and controller.requests_tracked_resources(p)]

    def run_until_idle(self, max_steps: int = 1000,
                       on_step: Optional[Callable[[], None]] = None) -> bool:
        """Step until no pending pod can be helped; False when
        ``max_steps`` ran out first. ``on_step`` runs after every step (a
        caller's invariant watch)."""
        settled = {c.kind: False for c in self.controllers}
        for _ in range(max_steps):
            before = self.fingerprint()
            processed = {c.kind: c.plans_processed for c in self.controllers}
            self.step()
            if on_step is not None:
                on_step()
            if self.fingerprint() != before:
                settled = {kind: False for kind in settled}
                continue
            for c in self.controllers:
                if not self.helpable(c) or (c.plans_processed > processed[c.kind]
                                            and c.last_applied == 0):
                    settled[c.kind] = True
            if all(settled.values()):
                return True
        return False

    # ----------------------------------------------------------- checks

    def unserved(self) -> Dict[str, str]:
        """Pending pod → why it waits: its quota's refusal, when the quota
        admission refuses it now, else the reason the last plan of its
        mode gave, else, for a gang member, that it waits in Permit for
        its gang, or the scheduler's last refusal (its gang's timeout
        among them)."""
        out: Dict[str, str] = {}
        for c in self.controllers:
            out.update(c.last_unserved)
        infos = build_quota_infos(self.store)
        waiting = self.scheduler.assumed()
        for pod in self.store.list("Pod"):
            if pod.phase == PodPhase.PENDING and not pod.node:
                status = CapacityScheduling.check_quota(pod, infos)
                if not status.success:
                    out[pod.namespaced_name] = status.message
                elif pod.namespaced_name in out:
                    continue
                elif pod.namespaced_name in waiting:
                    out[pod.namespaced_name] = (
                        f"waiting in Permit on {waiting[pod.namespaced_name]} for its gang")
                elif pod.unschedulable_message and gang_of(pod) is not None:
                    # the gang timeout, or the scheduler's diagnosis of a
                    # member the plan counts as placed (its pool pin
                    # refuses the plan's node)
                    out[pod.namespaced_name] = pod.unschedulable_message
        return out

    def check(self) -> Dict[str, bool]:
        """The idle cluster against the loop's invariants: every pod
        Running (or finished) or unserved with a reason, none failed; every reported MIG geometry
        allowed on its GPU; every spec plan acknowledged; no GPU
        over-committed (instances within its slices, MPS slices within
        its memory, running pods within what exists)."""
        pods = self.store.list("Pod")
        nodes = {n.name: n for n in self.store.list("Node")}
        unserved = self.unserved()
        running = [p for p in pods if p.phase == PodPhase.RUNNING]
        checks = {"pods_running_or_unserved": all(
            p.phase in (PodPhase.RUNNING, PodPhase.SUCCEEDED)
            or (p.phase == PodPhase.PENDING and bool(unserved.get(p.namespaced_name)))
            for p in pods)}
        allowed = committed = acked = True
        for node in nodes.values():
            kind = node.labels.get(PARTITIONING_LABEL)
            spec_plan = node.annotations.get(annot.SPEC_PARTITIONING_PLAN)
            acked &= not spec_plan or spec_plan == node.annotations.get(
                annot.STATUS_PARTITIONING_PLAN)
            _, status = annot.parse_node_annotations(node.annotations)
            reported = annot.status_geometries(status)
            product = node.labels.get(GPU_PRODUCT_LABEL, "")
            if kind == PARTITIONING_MIG:
                table = allowed_geometries(product)
                spec = KNOWN_GPUS[product]
                for geometry in reported.values():
                    allowed &= any(geometry_fits(g, geometry) for g in table)
                for geometry in self.pool.geometry(node.name).values():
                    memory, compute = geometry_slices(geometry)
                    committed &= memory <= spec.memory_slices and compute <= spec.compute_slices
                demand: Dict[str, int] = {}
                for p in running:
                    if p.node == node.name:
                        for profile, qty in mig_demand(p.request).items():
                            demand[profile] = demand.get(profile, 0) + qty
                have: Dict[str, int] = {}
                for geometry in self.pool.geometry(node.name).values():
                    for profile, qty in geometry.items():
                        have[profile] = have.get(profile, 0) + qty
                committed &= all(have.get(p, 0) >= q for p, q in demand.items())
            elif kind == PARTITIONING_MPS:
                memory = KNOWN_GPUS[product].memory_gb
                for geometry in reported.values():
                    committed &= sum(profile_gb(p) * q for p, q in geometry.items()) <= memory
                config = load_plugin_config(self.store, node.name, self.config_map_name) or {}
                replicas: Dict[str, int] = {}
                for entry in config.get("sharing", {}).get("resources", []):
                    replicas[entry["rename"]] = (replicas.get(entry["rename"], 0)
                                                 + int(entry["replicas"]))
                wanted: Dict[str, int] = {}
                for p in running:
                    if p.node == node.name:
                        for name, qty in p.request.items():
                            if name.startswith(MPS_RESOURCE_PREFIX) and is_mps_resource(name):
                                wanted[name] = wanted.get(name, 0) + int(qty)
                committed &= all(replicas.get(n, 0) >= q for n, q in wanted.items())
        checks.update(geometries_allowed=allowed, plans_acknowledged=acked,
                      no_gpu_overcommitted=committed)
        checks.update(self.check_quotas())
        checks.update(self.check_gangs())
        if self.ledger is not None:
            checks["capacity_ledger_consistent"] = not self.ledger.self_check()
        return checks

    def check_gangs(self) -> Dict[str, bool]:
        """The gangs' invariants, which hold at every step: every gang the
        expander made has none or all of its members bound, a bound gang
        lies in one node pool, its ranks are 0 … n-1 once each with the
        coordinator naming the leader; at most one node drains, and no
        reservation outlives its holder."""
        pods = self.store.list("Pod", copy=False)
        nodes = {n.name: n for n in self.store.list("Node", copy=False)}
        whole = one_pool = ranks = True
        for leader in pods:
            if leader.labels.get(MULTINODE_ROLE_LABEL) != ROLE_LEADER:
                continue
            gang, ns = leader.labels[GANG_NAME_LABEL], leader.namespace
            size = int(leader.labels[GANG_SIZE_LABEL])
            members = [p for p in pods
                       if p.namespace == ns and p.labels.get(GANG_NAME_LABEL) == gang]
            bound = [p for p in members
                     if p.node and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)]
            whole &= len(bound) in (0, size)
            one_pool &= len({nodes[p.node].labels.get(NODEPOOL_LABEL, "")
                             for p in bound if p.node in nodes}) <= 1
            want = gang_member_env(leader.name, ns, 0, size)
            ranks &= (sorted(int(p.env.get(PROCESS_ID_ENV, "-1")) for p in members)
                      == list(range(size))) and all(
                p.env.get(COORDINATOR_ENV) == want[COORDINATOR_ENV]
                and p.env.get(NUM_PROCESSES_ENV) == want[NUM_PROCESSES_ENV]
                for p in members)
        reservation = self.scheduler.reservation
        holders = [reservation.valid_holder(n) for n in nodes.values()
                   if RESERVED_FOR in n.annotations]
        return {"gangs_whole": whole, "gangs_in_one_pool": one_pool,
                "gang_ranks_and_coordinator": ranks,
                "at_most_one_drain": sum(h is not None for h in holders) <= 1,
                "no_stale_reservation": all(h is not None for h in holders)}

    def check_quotas(self) -> Dict[str, bool]:
        """The quotas' invariants: each quota's used is the sum over its
        running pods; every running pod a quota covers carries the label
        its accounting position gives it; no pod was evicted in-quota
        except by a higher-priority pod of its own quota (a borrower
        reclaims only over-quota pods)."""
        pods = self.store.list("Pod")
        used_ok = labels_ok = True
        composites = self.store.list("CompositeElasticQuota")
        covered = {ns for q in composites for ns in q.namespaces}
        quotas = [(q, list(q.namespaces)) for q in composites] + [
            (q, [q.namespace]) for q in self.store.list("ElasticQuota")
            if q.namespace not in covered]
        for quota, namespaces in quotas:
            running = [p for p in pods
                       if p.namespace in namespaces and p.phase == PodPhase.RUNNING]
            used, labels = quota_accounting(running, quota.min)
            used_ok &= {k: v for k, v in quota.used.items() if v} == {
                k: v for k, v in used.items() if v}
            labels_ok &= all(p.labels.get(CAPACITY_LABEL) == labels[p.namespaced_name]
                             for p in running)
        reclaim_ok = all(
            v["capacity"] == CAPACITY_OVER_QUOTA
            or (v["quota"] == record["quota"] and v["priority"] < record["priority"])
            for record in self.scheduler.preemptions for v in record["victims"])
        return {"quota_used_is_running_sum": used_ok,
                "capacity_labels_match_accounting": labels_ok,
                "no_in_quota_pod_preempted_by_borrower": reclaim_ok}
