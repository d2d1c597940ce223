"""MigActuator: spec annotations → MIG instances destroyed and created,
then a device-plugin restart; counterpart of
``nos_tpu/controllers/tpuagent/actuator.py:30`` (reference
internal/controllers/migagent/actuator.go:71-292).

A pass waits for a report since the last apply, diffs the node's devices
against its spec (``device/plan.compute_plan``), deletes, then creates
one batch a GPU (``GpuClient.create_devices``: all or none, searching
creation orders), restarts the device plugin and acknowledges the plan
(``SharedState.on_apply``). A plan with nothing to do is acknowledged at
once. The ``migagent.reconfig`` span is parented on the span linked
under ``("reconfig", node, plan_id)`` when one exists.

The clamp (reference ``:137-211``): a spec planned against stale state
can ask for more of a GPU than it has. Each GPU's creates are cut to the
memory and compute slices left after the instances that stay (the H100
table, ``gpu/known.py``), a GPU index beyond the node's ``nvidia.com/gpu``
capacity drops its creates, and the first clamp or drop of a plan is
logged as an error, its repeats (each pass re-reads the same stale spec)
at debug. A plan clamped to nothing is acknowledged without a plugin
restart: nothing changed, and the reporter publishes the true geometry. First-fit placement can still
refuse creates that fit the slice budget (``MigPlacementError`` after
the order search); that GPU's creates are given up the same way (NVML
creation failures are logged and re-reconciled, ``actuator.go:146-149``),
its log throttled alike. Any other error raises.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Protocol, Set, Tuple

from nos_tpu_torch.controllers.migagent.shared import SharedState
from nos_tpu_torch.device.client import GpuClient, MigPlacementError
from nos_tpu_torch.device.plan import MigPlan, compute_plan
from nos_tpu_torch.device.types import MigDevice
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS, mig_profile
from nos_tpu_torch.gpu.node import RESOURCE_GPU
from nos_tpu_torch.kube.store import Node, NodeStore
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.tracing import NOOP_SPAN, TRACER

log = logging.getLogger("nos_tpu_torch.migagent")

REQUEUE_SECONDS = 0.1


class DevicePlugin(Protocol):
    def restart(self, node_name: str) -> None: ...


class MigActuator:
    def __init__(self, store: NodeStore, client: GpuClient, device_plugin: DevicePlugin,
                 node_name: str, shared: SharedState) -> None:
        self.store = store
        self.client = client
        self.device_plugin = device_plugin
        self.node_name = node_name
        self.shared = shared
        # (plan id, GPU, profile, "capacity" or "placement") already logged as errors;
        # repeats of the same stale plan drop to debug. Reset when the plan
        # changes.
        self._logged: Set[Tuple[str, int, str]] = set()

    def _log_once(self, key: Tuple[str, int, str], msg: str, *args) -> None:
        self._logged = {k for k in self._logged if k[0] == key[0]}
        (log.debug if key in self._logged else log.error)(msg, *args)
        self._logged.add(key)

    def reconcile(self) -> Optional[float]:
        """One pass; the seconds to wait before the next when it is gated
        on a report, else None."""
        if not self.shared.at_least_one_report_since_last_apply():
            return REQUEUE_SECONDS
        node = self.store.try_get("Node", self.node_name)
        if node is None:
            return None
        spec, _ = annot.parse_node_annotations(node.annotations)
        plan_id = node.annotations.get(annot.SPEC_PARTITIONING_PLAN, "")
        devices = self.client.get_devices()
        plan = compute_plan(devices, annot.spec_geometries(spec))
        if plan.empty:
            self.shared.on_apply(plan_id)
            return None
        parent = TRACER.linked(("reconfig", self.node_name, plan_id))
        ctx = (TRACER.span("migagent.reconfig", parent=parent, node=self.node_name,
                           plan_id=plan_id)
               if parent is not None else contextlib.nullcontext(NOOP_SPAN))
        with ctx as span:
            for device in plan.deletes:
                self.client.delete_device(device.uuid)
                metrics.MIG_INSTANCES_DELETED.labels(profile=device.profile).inc()
                log.info("actuator: %s deleted %s (%s)", self.node_name, device.uuid,
                         device.profile)
            creates: Dict[int, Dict[str, int]] = {}
            for op in plan.creates:
                gpu = creates.setdefault(op.gpu_index, {})
                gpu[op.profile] = gpu.get(op.profile, 0) + op.quantity
            self._clamp(node, plan, plan_id, devices, creates)
            created = 0
            for gpu_index, profiles in sorted(creates.items()):
                try:
                    self.client.create_devices(gpu_index, profiles)
                except MigPlacementError as e:
                    self._log_once((plan_id, gpu_index, "placement"),
                                   "actuator: %s GPU %d: %s; the plan is acknowledged and "
                                   "the reporter publishes what exists", self.node_name,
                                   gpu_index, e)
                    continue
                for profile, qty in profiles.items():
                    metrics.MIG_INSTANCES_CREATED.labels(profile=profile).inc(qty)
                    created += qty
                log.info("actuator: %s created %s on GPU %d", self.node_name, profiles,
                         gpu_index)
            span.set_attributes(deleted=len(plan.deletes), created=created)
            if plan.deletes or created:
                self.device_plugin.restart(self.node_name)
            else:
                # clamped or refused to nothing: no device changed, so no
                # plugin restart; the ack lets the control plane replan
                span.set_attributes(clamped=True)
            self.shared.on_apply(plan_id)
        return None

    def _clamp(self, node: Node, plan: MigPlan, plan_id: str, devices: List[MigDevice],
               creates: Dict[int, Dict[str, int]]) -> None:
        """Cut ``creates`` (GPU → profile → count) to what each GPU has
        left after the instances that stay; drop GPUs the node lacks."""
        spec = KNOWN_GPUS.get(node.labels.get(GPU_PRODUCT_LABEL, ""))
        if spec is None:
            return
        gpus = int(node.capacity.get(RESOURCE_GPU, 0))
        deleted = {d.uuid for d in plan.deletes}
        memory: Dict[int, int] = {}
        compute: Dict[int, int] = {}
        for d in devices:
            if d.uuid not in deleted:
                p = mig_profile(d.profile)
                memory[d.gpu_index] = memory.get(d.gpu_index, 0) + p.memory_slices
                compute[d.gpu_index] = compute.get(d.gpu_index, 0) + p.compute_slices
        for gpu_index, profiles in sorted(creates.items()):
            if gpu_index >= gpus:
                self._log_once((plan_id, gpu_index, "capacity"),
                               "actuator: %s spec names GPU %d, the node has %d; dropping "
                               "its creates", self.node_name, gpu_index, gpus)
                profiles.clear()
                continue
            mem_left = spec.memory_slices - memory.get(gpu_index, 0)
            cmp_left = spec.compute_slices - compute.get(gpu_index, 0)
            for profile in sorted(profiles):
                p = mig_profile(profile)
                fit = max(0, min(profiles[profile], mem_left // p.memory_slices,
                                 cmp_left // p.compute_slices))
                if fit < profiles[profile]:
                    self._log_once((plan_id, gpu_index, profile),
                                   "actuator: %s GPU %d: spec wants %dx %s but %d memory and "
                                   "%d compute slices remain; clamping to %d (stale plan, "
                                   "will re-converge)", self.node_name, gpu_index,
                                   profiles[profile], profile, mem_left, cmp_left, fit)
                    profiles[profile] = fit
                mem_left -= fit * p.memory_slices
                cmp_left -= fit * p.compute_slices
            for profile in [p for p, q in profiles.items() if q <= 0]:
                del profiles[profile]
        for gpu_index in [g for g, p in creates.items() if not p]:
            del creates[gpu_index]
