"""MPS actuation: counterpart of ``nos_tpu/partitioning/sharing/partitioner.py``,
``:30`` (``plugin_config_from_partitioning``) and ``:59``
(``SharingPartitioner``; reference internal/partitioning/mps/partitioner.go:61-157).

The control plane renders a node's MPS geometries (GPU index →
{"<N>gb": count}) as the NVIDIA device plugin's sharing config, one
entry a GPU and profile: ``name: nvidia.com/gpu``, ``rename:
nvidia.com/gpu-<N>gb``, the GPU under ``devices``, the replicas, and
``fail_requests_greater_than_one: true`` (SURVEY §2.2). It writes the
config into the plugin's config map under ``<node>-<planId>``, drops the
entry the node's current label names (the one key the node owns: a
prefix match would also hit node "a-b"'s keys while cleaning node "a"),
then flips the node's ``nvidia.com/device-plugin.config`` label to the
new key. The reference's optional wait for the map to reach the
kubelet's volume is left out: nothing here reads a volume.
"""
from __future__ import annotations

import json
import logging
from typing import Mapping, Optional

from nos_tpu_torch.device.sharing import DEFAULT_CONFIG_MAP, DEVICE_PLUGIN_CONFIG_LABEL
from nos_tpu_torch.gpu.annotations import MPS_PROFILE_RE
from nos_tpu_torch.gpu.node import RESOURCE_GPU, mps_resource
from nos_tpu_torch.gpu.slicing import profile_gb
from nos_tpu_torch.kube.store import ConfigMap, NodeStore, NotFoundError

log = logging.getLogger("nos_tpu_torch.partitioning.mps")

PLUGIN_CONFIG_VERSION = "v1"


def plugin_config_from_geometries(geometries: Mapping[int, Mapping[str, int]]) -> dict:
    """The device plugin's sharing config for a node's MPS geometries: an
    entry a GPU (in the caller's order) and profile (by name)."""
    resources = []
    for gpu, geometry in geometries.items():
        for profile, qty in sorted(geometry.items()):
            if not MPS_PROFILE_RE.match(profile) or qty <= 0:
                continue
            resources.append({"name": RESOURCE_GPU, "rename": mps_resource(profile),
                              "memory_gb": profile_gb(profile), "devices": [gpu],
                              "replicas": int(qty)})
    return {"version": PLUGIN_CONFIG_VERSION,
            "sharing": {"fail_requests_greater_than_one": True, "resources": resources}}


class MpsPartitioner:
    def __init__(self, store: NodeStore, config_map_name: str = DEFAULT_CONFIG_MAP,
                 config_map_namespace: str = "") -> None:
        self.store = store
        self.config_map_name = config_map_name
        self.config_map_namespace = config_map_namespace

    def apply_partitioning(self, node_name: str, plan_id: str,
                           geometries: Mapping[int, Mapping[str, int]]) -> None:
        key = f"{node_name}-{plan_id}"
        config = plugin_config_from_geometries(geometries)
        node = self.store.try_get("Node", node_name)
        superseded = node.labels.get(DEVICE_PLUGIN_CONFIG_LABEL) if node is not None else None
        self._write_config(key, json.dumps(config, sort_keys=True), superseded)
        try:
            self.store.patch_labels("Node", node_name, "", {DEVICE_PLUGIN_CONFIG_LABEL: key})
        except NotFoundError:
            log.warning("apply_partitioning: node %s vanished", node_name)
            return
        log.info("apply_partitioning: node %s plan %s -> %d MPS resources", node_name,
                 plan_id, len(config["sharing"]["resources"]))

    def _write_config(self, key: str, payload: str, superseded: Optional[str]) -> None:
        if self.store.try_get("ConfigMap", self.config_map_name,
                              self.config_map_namespace) is None:
            self.store.create(ConfigMap(self.config_map_name, self.config_map_namespace,
                                        {key: payload}))
            return

        def mutate(cm: ConfigMap) -> None:
            # one live entry a node: the one its label names goes as the new
            # one comes (a plugin keeps its last state on a missing key)
            if superseded and superseded != key:
                cm.data.pop(superseded, None)
            cm.data[key] = payload

        self.store.patch_merge("ConfigMap", self.config_map_name, self.config_map_namespace,
                               mutate)
