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
stamps the plan id in the node's ``spec-partitioning-plan`` annotation,
then flips the node's ``nvidia.com/device-plugin.config`` label to the
new key. The node's MPS reporter acknowledges the plan once it reports
from that key (``MpsReporter``), so the partitioner's plan-id gate holds
an MPS node as it holds a MIG one. That stamp and its acknowledgement
are the port's own: the reference instead waits, optionally, for the
map to reach the kubelet's volume, which is left out (nothing here
reads a volume).

``MpsSnapshotTaker`` is the counterpart of
``nos_tpu/partitioning/sharing/snapshot_taker.py`` (reference
internal/partitioning/mps/snapshot_taker.go): nodes labelled
``nos.nebuly.com/gpu-partitioning=mps`` become ``MpsNode``s, and the
snapshot speaks the MPS codec.
"""
from __future__ import annotations

import json
import logging
from typing import Dict, List, Mapping, Optional

from nos_tpu_torch.device.sharing import DEFAULT_CONFIG_MAP, DEVICE_PLUGIN_CONFIG_LABEL
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.annotations import MPS_PROFILE_RE
from nos_tpu_torch.gpu.node import (
    PARTITIONING_LABEL,
    PARTITIONING_MPS,
    RESOURCE_GPU,
    MpsNode,
    mps_resource,
)
from nos_tpu_torch.gpu.slicing import profile_gb
from nos_tpu_torch.kube.store import ConfigMap, Node, NodeStore, NotFoundError, Pod
from nos_tpu_torch.partitioning.core.codec import MpsSliceCodec
from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.partitioning.core.state import ClusterState
from nos_tpu_torch.partitioning.mig import cluster_view, plan_in_flight

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
            # the stamp before the flip: the reporter never sees the new key
            # under the old plan id
            self.store.patch_annotations("Node", node_name, "",
                                         {annot.SPEC_PARTITIONING_PLAN: plan_id})
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


class MpsSnapshotTaker:
    def take_snapshot_node(self, node: Node, pods: List[Pod]) -> Optional[SnapshotNode]:
        """The node's snapshot entry, or None when it is not an MPS node."""
        if node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MPS:
            return None
        mps = MpsNode(node.name, node.labels, node.capacity, node.annotations)
        if not mps.gpus:
            return None
        return SnapshotNode(partitionable=mps, pods=list(pods), node=node,
                            frozen=plan_in_flight(node))

    def take_snapshot(self, state: ClusterState) -> ClusterSnapshot:
        nodes: Dict[str, SnapshotNode] = {}
        for name, (node, pods) in cluster_view(state).items():
            snap_node = self.take_snapshot_node(node, pods)
            if snap_node is not None:
                nodes[name] = snap_node
        return ClusterSnapshot(nodes, codec=MpsSliceCodec())
