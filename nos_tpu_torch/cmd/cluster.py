"""The threaded suite: every component on one store and one ``Manager``.

Counterpart of ``nos_tpu/cmd/cluster.py:43-275`` (``build_cluster``),
apart from ``SimCluster`` (``nos_tpu_torch/cluster.py``), whose polled
loop on a virtual clock stays as it is. ``build_cluster`` builds the
operator, the partitioner (both modes), the scheduler and, given its
config, the autoscaler through the component builders, with the sim
kubelet (``sim/kubelet.py``: a bound pod is admitted against the
instances that exist, then Running) and the MPS device plugin's sim.
``add_node`` creates a MIG node with its MIG agent on the suite's
``SimMigPool``, or an MPS node with its MPS agent. Everything runs on
threads in wall time once ``start()``; ``wait_idle`` waits for every
queue to settle. ``check()`` holds the store to ``SimCluster.check()``'s
invariants (every pod running or unserved with a reason, the geometries
allowed, every plan acknowledged, no GPU over-committed, the quotas' and
the gangs', the capacity ledger's self-check), the same code run on this
suite's parts. The suite keeps one ``CapacityLedger`` (``ledger``): the
MIG partitioner observes it after each plan and the scheduler stamps
the gang clocks on it (the reference's ``:182-199``). Given a
``flight_recorder`` every component records into it (attach it to the
store before the nodes are added, so their creation is replay's input).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from nos_tpu_torch.api.config import (
    AgentConfig,
    AutoscalerConfig,
    GpuPartitionerConfig,
    OperatorConfig,
    SchedulerConfig,
)
from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.cmd.autoscaler import build_autoscaler
from nos_tpu_torch.cmd.migagent import build_migagent, sim_devices
from nos_tpu_torch.cmd.mpsagent import add_sim_device_plugin, build_mpsagent
from nos_tpu_torch.cmd.operator import build_operator
from nos_tpu_torch.cmd.partitioner import build_partitioner
from nos_tpu_torch.cmd.scheduler import build_scheduler
from nos_tpu_torch.device.sharing import SharedSliceClient, SimSharedDevicePlugin
from nos_tpu_torch.device.sim import SimMigPool
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MPS
from nos_tpu_torch.kube.controller import Controller, Manager
from nos_tpu_torch.kube.store import Node, NodeStore
from nos_tpu_torch.sim.kubelet import SIM_KUBELET_WATCH, SimKubelet

# the agents' report interval in the suite (the reference's sim value)
SUITE_REPORT_SECONDS = 0.5


class SuiteCluster:
    """The suite's parts, and ``SimCluster``'s checks over them."""

    # SimCluster's invariants, read off this suite's store and parts
    check = SimCluster.check
    check_quotas = SimCluster.check_quotas
    check_gangs = SimCluster.check_gangs
    unserved = SimCluster.unserved

    def __init__(self, manager: Manager, pool: SimMigPool, partitioner, scheduler,
                 kubelet: SimKubelet, autoscaler=None, config_map_name: str = "",
                 ledger: Optional[CapacityLedger] = None, flight_recorder=None) -> None:
        self.manager = manager
        self.store: NodeStore = manager.store
        self.pool = pool
        self.partitioner = partitioner
        self.controllers = (partitioner, partitioner.mps)
        self.scheduler = scheduler
        self.kubelet = kubelet
        self.autoscaler = autoscaler
        self.config_map_name = config_map_name
        self.ledger = ledger
        self.flight_recorder = flight_recorder
        self.agents: Dict[str, object] = {}

    def add_node(self, node: Node, agent_config: Optional[AgentConfig] = None) -> Node:
        """Create the node and add its agent (MIG or MPS, by its label);
        before ``start()``, as the agents' controllers start with the
        manager."""
        created = self.store.create(node)
        config = agent_config or AgentConfig(report_config_interval_seconds=SUITE_REPORT_SECONDS)
        if node.labels.get(PARTITIONING_LABEL) == PARTITIONING_MPS:
            self.agents[node.name] = build_mpsagent(
                self.manager, node.name, SharedSliceClient(self.store, self.config_map_name),
                config)
        else:
            client, plugin = sim_devices(self.manager, node.name, self.pool)
            self.agents[node.name] = build_migagent(self.manager, node.name, client, plugin,
                                                    config)
        return created

    def start(self) -> None:
        self.manager.start()

    def stop(self) -> None:
        self.manager.stop()

    def wait_idle(self, timeout: float = 15.0, settle: float = 0.05) -> bool:
        return self.manager.wait_idle(timeout=timeout, settle=settle)

    def reconciles(self) -> Dict[str, int]:
        """Controller → the reconciles it ran."""
        return {c.name: c.reconciles for c in self.manager.controllers}

    def pods(self) -> List:
        """Every pod, as stored (read-only)."""
        return self.store.list("Pod", copy=False)


def build_cluster(partitioner_config: Optional[GpuPartitionerConfig] = None,
                  scheduler_config: Optional[SchedulerConfig] = None,
                  operator_config: Optional[OperatorConfig] = None,
                  autoscaler_config: Optional[AutoscalerConfig] = None,
                  flight_recorder=None, store: Optional[NodeStore] = None) -> SuiteCluster:
    store = store if store is not None else NodeStore()
    manager = Manager(store)
    # one ledger for the suite: the partitioner observes, the scheduler
    # stamps the gang clocks
    ledger = CapacityLedger(store, flight_recorder=flight_recorder)
    build_operator(manager, operator_config, flight_recorder=flight_recorder)
    partitioner_config = partitioner_config or GpuPartitionerConfig(
        batch_window_timeout_seconds=1.0, batch_window_idle_seconds=0.05)
    partitioner = build_partitioner(manager, partitioner_config, capacity_ledger=ledger,
                                    flight_recorder=flight_recorder)
    scheduler = build_scheduler(manager, scheduler_config, capacity_ledger=ledger,
                                flight_recorder=flight_recorder)
    autoscaler = None
    if autoscaler_config is not None:
        autoscaler = build_autoscaler(manager, autoscaler_config)
    pool = SimMigPool()
    # admission against the devices that exist: the backstop for a bind
    # racing a re-carve
    kubelet = SimKubelet(store, pool.geometry)
    manager.add(Controller("sim-kubelet", store, kubelet.reconcile, [SIM_KUBELET_WATCH]))
    config_map = partitioner_config.device_plugin_config_map
    add_sim_device_plugin(manager, SimSharedDevicePlugin(store, config_map))
    return SuiteCluster(manager, pool, partitioner, scheduler, kubelet, autoscaler,
                        config_map_name=config_map, ledger=ledger,
                        flight_recorder=flight_recorder)
