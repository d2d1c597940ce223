"""The MPS device plugin, simulated, and the MPS agent's read path:
counterpart of ``nos_tpu/device/sharing.py``.

In the reference nos the control plane renders a node's MPS layout into
the NVIDIA device plugin's config map under the key ``<node>-<planId>``
and points the node at it with the label ``nvidia.com/device-plugin.config``
(SURVEY §2.2, internal/partitioning/mps/partitioner.go:61-157); the
plugin re-registers and advertises each entry's replicas of GPU
``devices`` renamed ``nvidia.com/gpu-<N>gb``, at most one a container
(``fail_requests_greater_than_one``). ``load_plugin_config`` reads the
active entry; ``SimSharedDevicePlugin`` re-advertises the node's
allocatable from it and keeps the last state when the entry is gone
(mid-rollover, as a plugin that cannot reload does);
``SharedSliceClient`` derives each GPU's free and used slices from the
entry and the pods bound to the node (the slicing.Client analogue,
pkg/gpu/slicing/client.go).
"""
from __future__ import annotations

import copy
import json
import logging
from typing import Dict, List, Optional

from nos_tpu_torch.device.types import DeviceStatus, SharedSlice
from nos_tpu_torch.gpu.annotations import MPS_PROFILE_RE
from nos_tpu_torch.gpu.node import MPS_RESOURCE_PREFIX, RESOURCE_GPU
from nos_tpu_torch.kube.store import NodeStore, NotFoundError

log = logging.getLogger("nos_tpu_torch.device.sharing")

DEVICE_PLUGIN_CONFIG_LABEL = "nvidia.com/device-plugin.config"
DEFAULT_CONFIG_MAP = "nos-device-plugin-config"


def is_mps_resource(name: str) -> bool:
    """'nvidia.com/gpu-20gb' and the like."""
    return (name.startswith(MPS_RESOURCE_PREFIX)
            and bool(MPS_PROFILE_RE.match(name[len(MPS_RESOURCE_PREFIX):])))


def load_plugin_config(store: NodeStore, node_name: str,
                       config_map_name: str = DEFAULT_CONFIG_MAP,
                       config_map_namespace: str = "") -> Optional[dict]:
    """The node's active MPS config: label → config map key → JSON. None
    when the node has no label, the key is gone (a superseded plan) or
    the payload does not parse."""
    node = store.try_get("Node", node_name, copy=False)  # read-only
    if node is None:
        return None
    key = node.labels.get(DEVICE_PLUGIN_CONFIG_LABEL, "")
    if not key:
        return None
    cm = store.try_get("ConfigMap", config_map_name, config_map_namespace, copy=False)
    if cm is None or key not in cm.data:
        return None
    try:
        return json.loads(cm.data[key])
    except json.JSONDecodeError:
        log.warning("plugin config %s for node %s is not valid JSON", key, node_name)
        return None


def _entries(config: Optional[dict]) -> List[dict]:
    if not config:
        return []
    return list(config.get("sharing", {}).get("resources", []))


class SimSharedDevicePlugin:
    """Reconciles a node's allocatable against its active MPS config:
    what the NVIDIA device plugin does when its config label flips."""

    def __init__(self, store: NodeStore, config_map_name: str = DEFAULT_CONFIG_MAP,
                 config_map_namespace: str = "") -> None:
        self.store = store
        self.config_map_name = config_map_name
        self.config_map_namespace = config_map_namespace

    def reconcile(self, node_name: str) -> None:
        current = self.store.try_get("Node", node_name, copy=False)
        if current is None:
            return
        config = load_plugin_config(self.store, node_name, self.config_map_name,
                                    self.config_map_namespace)
        if config is None:
            # no loadable config (no label, or a key retired mid-rollover):
            # keep the last advertised state; wiping it would re-expose
            # the shared GPUs whole
            return
        shared: Dict[str, int] = {}
        covered = set()
        for entry in _entries(config):
            rename = entry.get("rename", "")
            if not is_mps_resource(rename):
                continue
            shared[rename] = shared.get(rename, 0) + int(entry.get("replicas", 0))
            covered.update(entry.get("devices", []))

        def mutate(node) -> None:
            target = node.allocatable
            for key in [k for k in target if is_mps_resource(k)]:
                del target[key]
            target.update(shared)
            # a GPU folded into MPS slices is no longer requestable whole
            target[RESOURCE_GPU] = max(0, int(node.capacity.get(RESOURCE_GPU, 0)) - len(covered))

        # a write that changes nothing is skipped: on a node watch it
        # would only wake the plugin again
        after = copy.copy(current)
        after.allocatable = dict(current.allocatable)
        mutate(after)
        if after.allocatable == current.allocatable:
            return
        try:
            self.store.patch_merge("Node", node_name, "", mutate)
        except NotFoundError:
            pass


class SharedSliceClient:
    """Per-GPU MPS slices for the MPS agent's reporter: the active config's
    replicas, used by the pods bound to the node in GPU order."""

    def __init__(self, store: NodeStore, config_map_name: str = DEFAULT_CONFIG_MAP,
                 config_map_namespace: str = "") -> None:
        self.store = store
        self.config_map_name = config_map_name
        self.config_map_namespace = config_map_namespace

    def get_devices(self, node_name: str) -> List[SharedSlice]:
        entries = _entries(load_plugin_config(self.store, node_name, self.config_map_name,
                                              self.config_map_namespace))
        if not entries:
            return []
        demand: Dict[str, int] = {}
        for pod in self.store.pods_by_node().get(node_name, ()):
            for name, qty in pod.request.items():
                if is_mps_resource(name):
                    demand[name] = demand.get(name, 0) + int(qty)
        devices: List[SharedSlice] = []
        ordered = sorted(entries, key=lambda e: (min(e.get("devices", [0]) or [0]),
                                                 e.get("rename", "")))
        serial = 0
        for entry in ordered:
            rename = entry.get("rename", "")
            if not is_mps_resource(rename):
                continue
            profile = rename[len(MPS_RESOURCE_PREFIX):]
            gpus = entry.get("devices", [0]) or [0]
            for _ in range(int(entry.get("replicas", 0))):
                serial += 1
                status = DeviceStatus.FREE
                if demand.get(rename, 0) > 0:
                    demand[rename] -= 1
                    status = DeviceStatus.USED
                devices.append(SharedSlice(f"mps-{node_name}-{gpus[0]}-{profile}-{serial}",
                                           int(gpus[0]), profile, status))
        return devices
