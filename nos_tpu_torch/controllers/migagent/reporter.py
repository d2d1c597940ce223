"""MigReporter: MIG devices → status annotations; counterpart of
``nos_tpu/controllers/tpuagent/reporter.py:24`` (reference
internal/controllers/migagent/reporter.go:54-123).

Each pass reads the node's MIG devices with their free / used status
(``GpuClient.get_devices``) and writes ``status-gpu-<i>-<profile>-<free|used>``
annotations. The plan handshake (``:60-82``): the status plan id becomes
the spec's when the reported geometry equals the spec's, and also when
the actuator last applied this plan though the devices diverge (a clamp
or a refused placement: withholding the ack would wedge the control
plane's plan gate); otherwise the old ack stays. The reporter owns only
the MIG-profile status keys and the ack: the MPS agent's keys share the
prefix and are never diffed here.

An error reading the devices raises: NVML's "Not Supported" on a GPU
with MIG off is never turned into an empty report.
"""
from __future__ import annotations

import logging

from nos_tpu_torch.controllers.migagent.shared import SharedState
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.device.types import DeviceStatus, device_geometry, group_geometries
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.kube.store import NodeStore

log = logging.getLogger("nos_tpu_torch.migagent")


def _owned(key: str) -> bool:
    return annot.is_mig_status_key(key) or key == annot.STATUS_PARTITIONING_PLAN


class MigReporter:
    def __init__(self, store: NodeStore, client: GpuClient, node_name: str,
                 shared: SharedState) -> None:
        self.store = store
        self.client = client
        self.node_name = node_name
        self.shared = shared

    def reconcile(self) -> None:
        node = self.store.try_get("Node", self.node_name, copy=False)  # read-only
        if node is None:
            return
        devices = self.client.get_devices()
        grouped = group_geometries(devices)
        desired = annot.status_from_devices(free=grouped[DeviceStatus.FREE],
                                            used=grouped[DeviceStatus.USED])
        spec_plan = node.annotations.get(annot.SPEC_PARTITIONING_PLAN, "")
        if spec_plan and (self.shared.spec_geometries(node) == device_geometry(devices)
                          or self.shared.last_applied_plan_id == spec_plan):
            desired[annot.STATUS_PARTITIONING_PLAN] = spec_plan
        elif annot.STATUS_PARTITIONING_PLAN in node.annotations:
            desired[annot.STATUS_PARTITIONING_PLAN] = node.annotations[
                annot.STATUS_PARTITIONING_PLAN]
        current = {k: v for k, v in node.annotations.items() if _owned(k)}
        if current != desired:
            patch = {k: None for k in current}
            patch.update(desired)
            self.store.patch_annotations("Node", self.node_name, "", patch)
            log.info("reporter: %s status updated (%d devices)", self.node_name, len(devices))
        self.shared.on_report()
