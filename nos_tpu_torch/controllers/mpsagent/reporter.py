"""MpsReporter: MPS slices → status annotations; counterpart of
``nos_tpu/controllers/sharingagent/reporter.py:26`` (reference
internal/controllers/gpuagent/reporter.go:50-110).

An MPS node has no local actuator, so its agent only mirrors the slices
the device plugin advertises, free or used (``SharedSliceClient``), into
``status-gpu-<i>-<N>gb-<free|used>`` annotations for ``MpsNode``. It
owns only MPS-profile status keys (the MIG reporter's and the plan ack
are never touched) and, as the reference's gpuagent refuses MIG nodes
(cmd/gpuagent/gpuagent.go:106-114), reports nothing on a node labelled
``nos.nebuly.com/gpu-partitioning=mig``.
"""
from __future__ import annotations

import logging

from nos_tpu_torch.device.sharing import SharedSliceClient
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
        node = self.store.try_get("Node", self.node_name)
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
        if current != desired:
            patch = {k: None for k in current}
            patch.update(desired)
            self.store.patch_annotations("Node", self.node_name, "", patch)
            log.info("mpsagent: %s status updated", self.node_name)
