"""The partitioner component: counterpart of ``nos_tpu/cmd/partitioner.py:30-321``
(reference cmd/gpupartitioner/gpupartitioner.go:72-268).

``build_partitioner`` registers the pod indexers, then wires, as the
reference:

- the state controllers of each mode's ``ClusterState``
  (``state-node-mig`` / ``state-pod-mig``, ``state-node-mps`` /
  ``state-pod-mps``: the port keeps a state a mode, where the reference
  shares one between its ``state-node`` and ``state-pod``); the MIG
  node controller gives a new MIG node its first geometry;
- ``partitioner-divergence`` (node annotation events) for the MIG
  controller alone, as the reference wires it to its TPU controller (an
  MPS plan is a config map, with no spec geometry to diverge from);
- ``partitioner-capacity-freed`` (a bound pod finished or went), which
  fires the batch of the mode whose resources the pod held, as the
  polled ``sync`` notes a freed node only for its own mode (the
  reference has the TPU mode alone); it fires at once, as the
  reference's does, without the polled loop's wait for a preemption's
  nominee: there the plan always ran before the scheduler's next cycle,
  here the scheduler's own thread binds the nominee;
- ``multinode-expander`` (the reference's ``multihost-expander``), on
  the pod watch through ``leader_deleted_mapper``;
- ``partitioner-mig`` and ``partitioner-mps`` (the reference's
  ``partitioner-tpu`` and ``partitioner-sharing``) on the pending pods,
  each with its batch thread as a runnable.

The capacity ledger, when given, goes to the MIG controller alone (one
observer a cluster, ``:164-167``). Both controllers share one
``EventRecorder(component="nos-partitioner")``, the ``flight_recorder``
when given (with the planners' aging in the session facts) and one
auditor, ``build_auditor(config.audit_sample_rate, ...)``: none at a
rate of 0 (the reference's ``:70-142``, ``:275``). The forecaster's
thread waits for item 18b.3; its config knob is refused
(``api/config/v1alpha1.py``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from nos_tpu_torch.api.config import GpuPartitionerConfig
from nos_tpu_torch.controllers.partitioner import (
    MultinodeExpander,
    PartitionerController,
    add_state_controllers,
    build_sim_framework,
)
from nos_tpu_torch.controllers.partitioner.multinode import leader_deleted_mapper
from nos_tpu_torch.controllers.partitioner.node_controller import ensure_pod_indexers
from nos_tpu_torch.device.sharing import is_mps_resource
from nos_tpu_torch.gpu.known import set_known_geometries
from nos_tpu_torch.gpu.node import PARTITIONING_MIG, PARTITIONING_MPS
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Watch
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.store import DELETED, Pod, PodPhase
from nos_tpu_torch.partitioning.core import Actuator, ClusterState, Planner
from nos_tpu_torch.partitioning.core.codec import is_mig_resource
from nos_tpu_torch.partitioning.mig import MigNodeInitializer, MigPartitioner, MigSnapshotTaker
from nos_tpu_torch.partitioning.mps import MpsPartitioner, MpsSnapshotTaker
from nos_tpu_torch.record.audit import build_auditor
from nos_tpu_torch.util.predicates import annotations_changed_or_added


def register_indexers(store) -> None:
    """The pod indexers every component reads
    (cmd/gpupartitioner/gpupartitioner.go:270-292)."""
    ensure_pod_indexers(store)


def _pending(event) -> bool:
    return event.type != DELETED and event.object.phase == PodPhase.PENDING


def _capacity_freed(event) -> bool:
    pod = event.object
    return bool(pod.node) and (event.type == DELETED
                               or pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED))


def build_partitioner(manager: Manager, config: Optional[GpuPartitionerConfig] = None,
                      capacity_ledger=None, flight_recorder=None) -> PartitionerController:
    """The MIG controller, with the MPS controller at ``.mps``."""
    config = config or GpuPartitionerConfig()
    config.validate()
    store = manager.store
    register_indexers(store)
    recorder = EventRecorder(store, component="nos-partitioner", clock=store.clock)
    if flight_recorder is not None:
        # replay's planners age pods as these do
        flight_recorder.record_session_meta(aging_per_second=config.aging_per_second)
    auditor = build_auditor(config.audit_sample_rate, recorder=recorder,
                            flight_recorder=flight_recorder)
    if config.known_mig_geometries:
        set_known_geometries(config.known_mig_geometries)
    # wall-clock ms and a counter: two plans in one millisecond never share an id
    counter = itertools.count(1)

    def plan_id() -> str:
        return f"{int(time.time() * 1000)}-{next(counter)}"

    def controller(kind, state, taker, partitioner, tracked, initializer=None, ledger=None):
        planner = Planner(build_sim_framework(store))
        planner.aging_per_second = config.aging_per_second
        return PartitionerController(
            store, state, taker, planner, Actuator(partitioner), kind, tracked,
            config.batch_window_timeout_seconds, config.batch_window_idle_seconds, plan_id,
            initializer=initializer, incremental_planning=config.incremental_planning,
            incremental_dirty_threshold=config.incremental_dirty_threshold,
            pool_sharding=config.pool_sharding, pool_backend=config.plan_backend,
            pool_cycle_timeout_seconds=config.pool_cycle_timeout_seconds,
            # the modes memoize against different snapshots: a file each
            warm_state_path=f"{config.warm_state_path}.{kind}" if config.warm_state_path
            else "",
            warm_state_save_interval_seconds=config.warm_state_save_interval_seconds,
            capacity_ledger=ledger, state_feed=lambda: None,
            scheduler_name=config.scheduler_name, recorder=recorder,
            flight_recorder=flight_recorder, auditor=auditor)

    mig_partitioner = MigPartitioner(store)
    initializer = MigNodeInitializer(mig_partitioner, plan_id)
    mig_state, mps_state = ClusterState(), ClusterState()
    add_state_controllers(manager, mig_state, initializer, PARTITIONING_MIG, "-mig")
    add_state_controllers(manager, mps_state, None, PARTITIONING_MPS, "-mps")
    mig = controller(PARTITIONING_MIG, mig_state, MigSnapshotTaker(), mig_partitioner,
                     is_mig_resource, initializer, capacity_ledger)
    mps = controller(PARTITIONING_MPS, mps_state, MpsSnapshotTaker(),
                     MpsPartitioner(store, config.device_plugin_config_map), is_mps_resource)

    # the pod each freed request names, as its event carried it (a
    # deleted pod is gone from the store): its resources pick the mode
    freed: Dict[str, Pod] = {}
    freed_lock = threading.Lock()

    def freed_mapper(event) -> List[Request]:
        pod = event.object
        with freed_lock:
            freed[pod.namespaced_name] = pod
        return [Request(pod.name, pod.namespace)]

    def capacity_freed(req: Request):
        with freed_lock:
            pod = freed.pop(req.namespaced_name, None)
        for c in (mig, mps) if pod is not None else ():
            if c.requests_tracked_resources(pod):
                c.reconcile_freed_event(req)
        return None

    manager.add(Controller("partitioner-divergence", store, mig.reconcile_divergence_event, [
        Watch("Node", predicate=annotations_changed_or_added)]))
    manager.add(Controller("partitioner-capacity-freed", store, capacity_freed, [
        Watch("Pod", predicate=_capacity_freed, mapper=freed_mapper)]))
    expander = MultinodeExpander(store)
    manager.add(Controller("multinode-expander", store, expander.reconcile, [
        Watch("Pod", mapper=leader_deleted_mapper(store))]))
    for kind, c in ((PARTITIONING_MIG, mig), (PARTITIONING_MPS, mps)):
        manager.add(Controller(f"partitioner-{kind}", store, c.reconcile, [
            Watch("Pod", predicate=_pending)]))
        manager.add_runnable(c.start, c.stop)
    mig.mps = mps
    return mig


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch partitioner``."""
    from nos_tpu_torch.cmd._component import run_component
    from nos_tpu_torch.cmd.run import configs_from

    return run_component("partitioner", lambda manager, config: build_partitioner(
        manager, configs_from(config).partitioner), argv, **run)
