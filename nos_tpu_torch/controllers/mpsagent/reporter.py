"""MpsReporter: MPS slices → status annotations; counterpart of
``nos_tpu/controllers/sharingagent/reporter.py:26`` (reference
internal/controllers/gpuagent/reporter.go:50-110).

An MPS node has no local actuator, so its agent only mirrors the slices
the device plugin advertises, free or used (``SharedSliceClient``), into
``status-gpu-<i>-<N>gb-<free|used>`` annotations for ``MpsNode``. It
owns the MPS-profile status keys (the MIG reporter's are never touched)
and, as the reference's gpuagent refuses MIG nodes
(cmd/gpuagent/gpuagent.go:106-114), reports nothing on a node labelled
``nos.nebuly.com/gpu-partitioning=mig``. It also acknowledges the
partitioner's MPS plan, which the reference's agent does not: when the
device plugin's config label names ``<node>-<spec plan id>`` and that
config loads, the slices it reports come from that plan, and it writes
the id into ``status-partitioning-plan`` in the same patch. It never
removes an acknowledgement.
"""
from __future__ import annotations

import logging

from nos_tpu_torch.device.sharing import (
    DEVICE_PLUGIN_CONFIG_LABEL,
    SharedSliceClient,
    load_plugin_config,
)
from nos_tpu_torch.device.types import DeviceStatus, group_geometries
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG
from nos_tpu_torch.kube.store import NodeStore

log = logging.getLogger("nos_tpu_torch.mpsagent")


class MpsReporter:
    def __init__(self, store: NodeStore, client: SharedSliceClient, node_name: str) -> None:
        self.store = store
        self.client = client
        self.node_name = node_name

    def reconcile(self) -> None:
        node = self.store.try_get("Node", self.node_name, copy=False)  # read-only
        if node is None:
            return
        if node.labels.get(PARTITIONING_LABEL, "") == PARTITIONING_MIG:
            log.warning("mpsagent on %s: the node is labelled for MIG, refusing to report",
                        self.node_name)
            return
        grouped = group_geometries(self.client.get_devices(self.node_name))
        desired = annot.status_from_devices(free=grouped[DeviceStatus.FREE],
                                            used=grouped[DeviceStatus.USED])
        current = {k: v for k, v in node.annotations.items() if annot.is_mps_status_key(k)}
        ack = self._plan_to_acknowledge(node)
        if ack:
            desired[annot.STATUS_PARTITIONING_PLAN] = ack
            current[annot.STATUS_PARTITIONING_PLAN] = node.annotations.get(
                annot.STATUS_PARTITIONING_PLAN)
        if current != desired:
            patch = {k: None for k in current}
            patch.update(desired)
            self.store.patch_annotations("Node", self.node_name, "", patch)
            log.info("mpsagent: %s status updated", self.node_name)

    def _plan_to_acknowledge(self, node) -> str:
        """The spec plan id once the slices come from its config; ''
        while it is acknowledged already or still rolling out."""
        spec_plan = node.annotations.get(annot.SPEC_PARTITIONING_PLAN, "")
        if not spec_plan or spec_plan == node.annotations.get(annot.STATUS_PARTITIONING_PLAN):
            return ""
        if node.labels.get(DEVICE_PLUGIN_CONFIG_LABEL) != f"{self.node_name}-{spec_plan}":
            return ""
        if load_plugin_config(self.store, self.node_name, self.client.config_map_name,
                              self.client.config_map_namespace) is None:
            return ""
        return spec_plan
