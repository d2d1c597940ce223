"""The MIG agent component: counterpart of ``nos_tpu/cmd/tpuagent.py:27-168``
(reference cmd/migagent/migagent.go:56-199), one a node (``NODE_NAME``).

``build_migagent`` puts the node's ``MigReporter`` and ``MigActuator``
(``controllers/migagent/``) on the manager, as the reference's
``build_tpuagent``: the reporter on its node's events and the events of
the pods on it, requeued every ``report_config_interval_seconds``; the
actuator on its node's events, requeued while it waits for a report
since its last apply; every apply queues a report at once, so a plan's
ack never waits out the interval (an apply clamped to nothing changes no
device and wakes nothing else). A GPU whose MIG mode is off is refused
before anything runs (``MigModeDisabledError``: NVML answers a MIG query
there with "Not Supported", which no report may read as a GPU without
instances). ``SimCluster``'s polled ``MigAgent`` stays as it is.

The device backend, from the config's ``deviceBackend``: ``sim`` (the
default) a ``SimMigPool`` in the process, advertised by its device
plugin's sim; ``nvml`` the card's NVML (``device/nvml.py``), with the
kubelet's pod-resources client where ``podResourcesSocket`` names its
socket, else the store's bindings.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

from nos_tpu_torch.api.config import AgentConfig
from nos_tpu_torch.controllers.migagent import MigActuator, MigReporter, SharedState
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Result, Watch
from nos_tpu_torch.util.predicates import matching_name


@dataclass
class MigAgentHandles:
    shared: SharedState
    reporter: MigReporter
    actuator: MigActuator
    reporter_controller: Controller


def pod_on_node_mapper(node_name: str):
    """A pod's event on ``node_name`` changes its devices' use: report."""
    def mapper(event):
        return [Request(node_name)] if event.object.node == node_name else []

    return mapper


def build_migagent(manager: Manager, node_name: str, client: GpuClient, device_plugin,
                   config: Optional[AgentConfig] = None) -> MigAgentHandles:
    config = config or AgentConfig()
    config.validate()
    require = getattr(client.device_client, "require_mig_enabled", None)
    if require is not None:
        require()
    store = manager.store
    interval = config.report_config_interval_seconds
    shared = SharedState()
    reporter = MigReporter(store, client, node_name, shared)
    actuator = MigActuator(store, client, device_plugin, node_name, shared)

    def report(req: Request) -> Optional[Result]:
        reporter.reconcile()
        return Result(requeue_after=interval)

    def actuate(req: Request) -> Optional[Result]:
        if req.name != node_name:
            return None
        delay = actuator.reconcile()
        return Result(requeue_after=delay) if delay else None

    reporter_controller = manager.add(Controller(f"migagent-reporter-{node_name}", store,
                                                 report, [
        Watch("Node", predicate=matching_name(node_name)),
        Watch("Pod", mapper=pod_on_node_mapper(node_name))]))
    shared.add_apply_listener(lambda _plan_id: reporter_controller.queue.add(Request(node_name)))
    manager.add(Controller(f"migagent-actuator-{node_name}", store, actuate, [
        Watch("Node", predicate=matching_name(node_name))]))
    return MigAgentHandles(shared, reporter, actuator, reporter_controller)


def sim_devices(manager: Manager, node_name: str, pool=None):
    """(client, device plugin) over a ``SimMigPool`` (a fresh one by default)."""
    from nos_tpu_torch.device.sim import (
        SimDevicePlugin,
        SimMigClient,
        SimMigPool,
        SimPodResourcesClient,
    )

    pool = pool or SimMigPool()
    sim = SimMigClient(pool, node_name)
    client = GpuClient(sim, SimPodResourcesClient(manager.store, node_name,
                                                  sim.get_mig_devices))
    return client, SimDevicePlugin(manager.store, pool)


def nvml_devices(manager: Manager, node_name: str, config: dict):
    """(client, device plugin) over the card's NVML."""
    from nos_tpu_torch.device.nvml import Nvml, NvmlMigClient
    from nos_tpu_torch.device.sim import DevicePluginAdvertiser, SimPodResourcesClient
    from nos_tpu_torch.device.types import device_geometry

    nvml = NvmlMigClient(Nvml())
    socket_path = config.get("podResourcesSocket", "")
    if socket_path:
        from nos_tpu_torch.device.podresources import KubeletPodResourcesClient

        pod_resources = KubeletPodResourcesClient(socket_path=socket_path)
    else:
        pod_resources = SimPodResourcesClient(manager.store, node_name, nvml.get_mig_devices)
    plugin = DevicePluginAdvertiser(manager.store,
                                    lambda _node: device_geometry(nvml.get_mig_devices()))
    return GpuClient(nvml, pod_resources), plugin


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch migagent`` (needs ``NODE_NAME``)."""
    from nos_tpu_torch.cmd._component import run_component
    from nos_tpu_torch.cmd.run import configs_from
    from nos_tpu_torch.device.nvml import MigModeDisabledError, NvmlUnavailableError

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        print("migagent: the NODE_NAME environment variable is required", file=sys.stderr)
        return 1

    def build(manager, config):
        backend = config.get("deviceBackend", "sim")
        if backend == "nvml":
            client, plugin = nvml_devices(manager, node_name, config)
        elif backend == "sim":
            client, plugin = sim_devices(manager, node_name)
        else:
            raise ValueError(f"unknown deviceBackend {backend!r}: 'sim' or 'nvml'")
        return build_migagent(manager, node_name, client, plugin, configs_from(config).agent)

    try:
        return run_component(f"migagent[{node_name}]", build, argv, **run)
    except (MigModeDisabledError, NvmlUnavailableError) as e:
        print(f"migagent: {e}", file=sys.stderr)
        return 1
