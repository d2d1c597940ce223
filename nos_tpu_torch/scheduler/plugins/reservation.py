"""Drain reservation for whole-GPU requests, and the autoscaler's grace
score.

Counterpart of ``nos_tpu/scheduler/plugins/reservation.py``:
``BoardReservation`` (``:50-262``) and ``AutoscalerGraceScoring``
(``:265-287``).

A pod asking for a whole H100 or more (at least 8 memory slices: a
7g.80gb, or several GPUs' worth) can starve on a busy cluster: every
slice freed is re-carved at once for smaller pending pods, so a whole GPU
frees only by luck. When such a pod has waited ``min_wait`` seconds, is
unschedulable with no preemption nomination, and no MIG node has the
headroom for it (its GPUs' 8 memory slices each, less those its pods'
instances hold), the scheduler reserves the MIG node closest to draining
(fewest slices held, then name) by writing ``nos.nebuly.com/reserved-for:
<ns/name>`` and ``reserved-at`` on it. The filter keeps every other pod
off a validly reserved node, in the scheduler and in the planner's
simulation, so nothing is carved there for anyone else; the node drains,
is re-carved for the holder, the holder binds and its bind releases the
reservation. One drain at a time in the cluster (the single-drain
policy: another pod's valid reservation on any node blocks a new one,
where the reference looks only at the nodes it could reserve, ROADMAP.md
fault F5); a node with a pending pod on it (a gang member's assumed
claim) is contested, never reserved. A reservation is valid while its
holder is a pending unbound pod and its TTL has not run out;
``release_invalid`` (run once a scheduler step, in place of the
reference's janitor) clears the others. MPS nodes are never reserved: their slices are memory shares
that free without a drain. Times are read from the store's clock, where
the reference reads ``time.time``.

``AutoscalerGraceScoring`` softly steers a returning model to the node
the autoscaler held for it (``nos.nebuly.com/autoscaler-reserved``): its
replicas score 50 there, unrelated pods 0, and 30 anywhere unreserved.
The autoscaler (``controllers/autoscaler``) writes that annotation on a
scale to zero.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from nos_tpu_torch.api.v1alpha1.modelserving import MODEL_SERVING_LABEL
from nos_tpu_torch.gpu.annotations import AUTOSCALER_RESERVED, PREFIX
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU
from nos_tpu_torch.kube.store import Node, NodeStore, NotFoundError, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import CycleState, NodeInfo, Status
from nos_tpu_torch.scheduler.preemption import mig_slices_in
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util import resources as res

log = logging.getLogger("nos_tpu_torch.scheduler")

RESERVED_FOR = PREFIX + "reserved-for"
RESERVED_AT = PREFIX + "reserved-at"

_VALID_CACHE_KEY = "board_reservation_valid"


def _reserved_at(node: Node) -> float:
    try:
        return float(node.annotations.get(RESERVED_AT, "0") or 0)
    except ValueError:
        return 0.0


class BoardReservation:
    name = "BoardReservation"

    def __init__(self, store: NodeStore, ttl_seconds: float = 30.0,
                 min_wait_seconds: float = 10.0) -> None:
        self.store = store
        self.ttl = ttl_seconds
        # a safety net, not a fast path: only a pod that has waited this
        # long gets a node drained for it
        self.min_wait = min_wait_seconds
        self.reservations_made = 0

    # ------------------------------------------------------------ filter

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if RESERVED_FOR not in node_info.node.annotations:
            return Status.ok()
        cache: Dict[str, Optional[str]] = state.setdefault(_VALID_CACHE_KEY, {})
        if node_info.name not in cache:
            cache[node_info.name] = self.valid_holder(node_info.node)
        holder = cache[node_info.name]
        if holder is not None and holder != pod.namespaced_name:
            return Status.unschedulable(f"node draining, reserved for {holder}", self.name)
        return Status.ok()

    def valid_holder(self, node: Node) -> Optional[str]:
        """The node's holder while its reservation is valid, else None."""
        holder = node.annotations.get(RESERVED_FOR, "")
        if not holder or self.store.clock() - _reserved_at(node) > self.ttl:
            return None
        ns, _, name = holder.partition("/")
        pod = self.store.try_get("Pod", name, ns, copy=False)
        if pod is None or pod.node or pod.phase != PodPhase.PENDING:
            return None
        return holder

    # ----------------------------------------------------------- reserve

    def try_reserve(self, pod: Pod, node_infos: Dict[str, NodeInfo]) -> bool:
        """After a cycle left ``pod`` unschedulable with no nomination:
        reserve at most one node, if the pod asks for a whole GPU or more,
        has waited ``min_wait`` and no MIG node has the headroom for it."""
        now = self.store.clock()
        created = pod.created if pod.created is not None else now
        if now - created < self.min_wait:
            return False
        needed = mig_slices_in(res.compute_pod_request(pod))
        if needed <= 0:
            return False
        key = pod.namespaced_name
        # one drain in the cluster: another pod's valid reservation on any
        # node blocks a new one (F5)
        other_drain = any(self.valid_holder(info.node) not in (None, key)
                          for info in node_infos.values()
                          if RESERVED_FOR in info.node.annotations)
        best = None  # (slices held, name)
        for info in sorted(node_infos.values(), key=lambda i: i.name):
            node = info.node
            if node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
                continue
            spec = KNOWN_GPUS.get(node.labels.get(GPU_PRODUCT_LABEL, ""))
            if spec is None:
                continue
            capacity = int(node.capacity.get(RESOURCE_GPU, 0)) * spec.memory_slices
            if capacity < needed or needed < spec.memory_slices:
                # a sub-GPU fragment re-carves out of normal churn
                continue
            held = sum(mig_slices_in(res.compute_pod_request(p)) for p in info.pods)
            if capacity - held >= needed:
                return False  # the partitioner can serve it without a drain
            if any(p.phase == PodPhase.PENDING for p in info.pods):
                continue  # contested by an in-flight claim
            holder = self.valid_holder(node)
            if holder == key:
                # refresh a half-spent TTL so a slow drain is not lost
                if now - _reserved_at(node) > self.ttl / 2:
                    self._annotate(node.name, key)
                return True
            if holder is not None:
                other_drain = True
                continue
            if best is None or (held, info.name) < best:
                best = (held, info.name)
        if best is None or other_drain:
            return False
        self._annotate(best[1], key)
        self.reservations_made += 1
        metrics.BOARD_RESERVATIONS.inc()  # as the reference's :181
        log.info("scheduler: reserved %s for %s (%g memory slices need a drained GPU)",
                 best[1], key, needed)
        return True

    def _annotate(self, node_name: str, holder: str) -> None:
        try:
            self.store.patch_annotations("Node", node_name, "", {
                RESERVED_FOR: holder, RESERVED_AT: repr(self.store.clock())})
        except NotFoundError:
            pass

    # ----------------------------------------------------------- release

    def _clear(self, node_name: str) -> bool:
        try:
            self.store.patch_annotations("Node", node_name, "",
                                         {RESERVED_FOR: None, RESERVED_AT: None})
        except NotFoundError:
            return False
        return True

    def release_invalid(self) -> int:
        """Clear every reservation whose holder is no longer valid; the
        nodes cleared."""
        cleared = 0
        for node in self.store.list("Node", copy=False):
            if RESERVED_FOR in node.annotations and self.valid_holder(node) is None:
                if self._clear(node.name):
                    cleared += 1
                    log.info("scheduler: cleared the stale reservation of %s (holder %s)",
                             node.name, node.annotations.get(RESERVED_FOR, ""))
        return cleared

    def any_reserved(self) -> bool:
        return any(RESERVED_FOR in n.annotations for n in self.store.list("Node", copy=False))

    def release_for(self, pod: Pod) -> None:
        """Clear the reservation ``pod`` holds (on its bind)."""
        key = pod.namespaced_name
        for node in self.store.list("Node", copy=False):
            if node.annotations.get(RESERVED_FOR) == key and self._clear(node.name):
                log.info("scheduler: released the reservation of %s held by %s",
                         node.name, key)


class AutoscalerGraceScoring:
    name = "AutoscalerGraceScore"

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        holder = node_info.node.annotations.get(AUTOSCALER_RESERVED, "")
        if not holder:
            return 30
        return 50 if pod.labels.get(MODEL_SERVING_LABEL, "") == holder else 0
