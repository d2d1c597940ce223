"""The MPS agent component: counterpart of ``nos_tpu/cmd/sharingagent.py:18-81``
(reference cmd/gpuagent/gpuagent.go:54-152), one a node (``NODE_NAME``).

Reporter only, as the reference: an MPS plan is actuated through the
device plugin's config map, not by the agent. The reporter runs on its
node's events, the events of the pods on it and every config map event
(a new plugin config exposes new slices), requeued every
``report_config_interval_seconds``. With ``deviceBackend: sim`` (the
default) the process also runs the MPS device plugin's sim for its node
(``SimSharedDevicePlugin``: the node's allocatable follows its active
config), which a cluster's NVIDIA device plugin does on a real node.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

from nos_tpu_torch.api.config import AgentConfig
from nos_tpu_torch.cmd.migagent import pod_on_node_mapper
from nos_tpu_torch.controllers.mpsagent import MpsReporter
from nos_tpu_torch.device.sharing import DEVICE_PLUGIN_CONFIG_LABEL, SharedSliceClient
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Result, Watch
from nos_tpu_torch.util.predicates import matching_name


def build_mpsagent(manager: Manager, node_name: str, client: SharedSliceClient,
                   config: Optional[AgentConfig] = None) -> MpsReporter:
    config = config or AgentConfig()
    config.validate()
    interval = config.report_config_interval_seconds
    reporter = MpsReporter(manager.store, client, node_name)

    def report(req: Request) -> Optional[Result]:
        reporter.reconcile()
        return Result(requeue_after=interval)

    manager.add(Controller(f"mpsagent-reporter-{node_name}", manager.store, report, [
        Watch("Node", predicate=matching_name(node_name)),
        Watch("Pod", mapper=pod_on_node_mapper(node_name)),
        Watch("ConfigMap", mapper=lambda e: [Request(node_name)])]))
    return reporter


def add_sim_device_plugin(manager: Manager, plugin, name: str = "sim-shared-device-plugin",
                          node_name: str = "") -> None:
    """The MPS device plugin's sim on the nodes carrying its config label
    (``node_name``'s alone when given): re-advertised on their events and
    on every config map's."""
    store = manager.store

    def labeled_nodes(event):
        return [Request(n.name) for n in store.list("Node", copy=False)
                if DEVICE_PLUGIN_CONFIG_LABEL in n.labels
                and (not node_name or n.name == node_name)]

    def reconcile(req: Request) -> None:
        plugin.reconcile(req.name)

    manager.add(Controller(name, store, reconcile, [
        Watch("Node", predicate=lambda e: e.type != "DELETED"
              and DEVICE_PLUGIN_CONFIG_LABEL in e.object.labels
              and (not node_name or e.object.name == node_name)),
        Watch("ConfigMap", mapper=labeled_nodes)]))


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch mpsagent`` (needs ``NODE_NAME``)."""
    from nos_tpu_torch.cmd._component import run_component
    from nos_tpu_torch.cmd.run import configs_from
    from nos_tpu_torch.device.sharing import SimSharedDevicePlugin

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        print("mpsagent: the NODE_NAME environment variable is required", file=sys.stderr)
        return 1

    def build(manager, config):
        config_map = config.get("devicePluginConfigMap",
                                configs_from(config).partitioner.device_plugin_config_map)
        backend = config.get("deviceBackend", "sim")
        if backend == "sim":
            add_sim_device_plugin(
                manager, SimSharedDevicePlugin(manager.store, config_map),
                f"sim-shared-device-plugin-{node_name}", node_name)
        elif backend != "nvml":
            raise ValueError(f"unknown deviceBackend {backend!r}: 'sim' or 'nvml'")
        return build_mpsagent(manager, node_name, SharedSliceClient(manager.store, config_map),
                              configs_from(config).agent)

    return run_component(f"mpsagent[{node_name}]", build, argv, **run)
