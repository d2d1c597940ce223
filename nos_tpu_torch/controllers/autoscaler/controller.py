"""The ModelServing reconciler: burn-rate verdicts to replica pods.

Counterpart of ``nos_tpu/controllers/autoscaler/controller.py:51-381``
(``ModelServingReconciler``, ``serving_key``, ``replica_name``) and
``:383`` (``pod_to_serving_requests``). The reconciler reads signals
and writes pods, the ModelServing's status and node annotations,
nothing else: a replica pod asks ``nvidia.com/mig-<profile>: 1`` and
is a gang of one, and the scheduler, the partitioner and the quotas
place and carve for it as for any pod.

Replica pods are ``<ms>-replica-<i>`` with dense indices: a scale up
creates the lowest missing indices, a scale down deletes from the top,
so each (current, desired) pair maps to one set of writes and a repeated
reconcile is idempotent.

A scale to zero stamps a cold-start grace hold for each replica it
vacates on that replica's MIG node (``gpu/annotations.py``:
``GraceHold``, ``AUTOSCALER_HOLDS``): its holder, the memory slices of
the replica's profile and its own expiry. A node keeps several holds at
once, so a second model's scale to zero on an 8-GPU node adds its hold
beside the first, where the reference's node (one board) holds one. The
capacity ledger books the held GB to ``autoscaler-grace``, the
scheduler's ``AutoscalerGraceScoring`` steers the model's cold start
back there, and each hold expires on the reconciler's clock (the signal
registry's ``now_fn``, which defaults to the store's clock), so a held
node cannot leak. On a one-GPU node with a ``7g.80gb`` replica the two
summary annotations are the reference's hold, value for value.

``reconcile(name, namespace)`` is the reference's reconcile of one
request. The autoscaler component (``cmd/autoscaler.py``) runs it on the
ModelServing watch and the replica pods' watch (``serving_requests_of``,
the reference's ``pod_to_serving_requests`` mapper) through
``reconcile_request``, which requeues a live ModelServing after
``resync_seconds`` so idle timers and grace holds are read with no event
(the reference also requeues at a hold's expiry; here a hold expires at
the next resync). ``SimCluster`` polls (ROADMAP.md, Queue 3): ``step()``
reconciles every ModelServing, then collects the replicas of a deleted
one (``pod_to_serving_requests``, the mapper as a function of a pod).
With an ``EventRecorder`` (``recorder``) a scale up records ``ScaledUp``
(and first ``ColdStart`` when it is one), a scale down ``ScaledDown`` or
``ScaledToZero`` (the reference's ``:104-117``, ``:266-303``); the
messages are the reference's with one H100 word: a scale to zero's hold
counts "memory slices" where the reference counts chips (the same
numbers under the parity tests' translation). ``decisions`` keeps the
last ``DECISION_RECORDS`` decisions beside the events. The status goes
through ``NodeStore.patch_merge``.
"""
from __future__ import annotations

import logging
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.modelserving import MODEL_SERVING_LABEL, ModelServing
from nos_tpu_torch.controllers.autoscaler import policy
from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry
from nos_tpu_torch.gpu.annotations import GraceHold, grace_hold_patch, grace_holds
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, mig_resource
from nos_tpu_torch.kube.controller import Request, Result
from nos_tpu_torch.kube.store import AlreadyExistsError, NodeStore, NotFoundError, Pod, WatchEvent
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.resources import node_memory_slices
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.autoscaler")

DECISION_RECORDS = 1024


def _merge_annotations(obj, patch) -> None:
    for k, v in patch.items():
        if v is None:
            obj.annotations.pop(k, None)
        else:
            obj.annotations[k] = v


def serving_key(ms: ModelServing) -> str:
    """The label value tying replica pods to their ModelServing (a label
    value holds no '/', so the namespaced name is dot-joined)."""
    return f"{ms.namespace}.{ms.name}"


def replica_name(ms_name: str, index: int) -> str:
    return f"{ms_name}-replica-{index}"


def pod_to_serving_requests(pod: Pod) -> List[Tuple[str, str]]:
    """The (name, namespace) of the ModelServing a replica pod belongs to
    (the reference's watch mapper, as a function of the pod)."""
    key = pod.labels.get(MODEL_SERVING_LABEL)
    if not key or "." not in key:
        return []
    ns, _, name = key.partition(".")
    return [(name, ns)]


def serving_requests_of(event: WatchEvent) -> List[Request]:
    """The replica pods' watch mapper: a replica's event maps to its
    ModelServing."""
    return [Request(name, ns) for name, ns in pod_to_serving_requests(event.object)]


class ModelServingReconciler:
    def __init__(self, store: NodeStore, config: Optional[AutoscalerConfig] = None,
                 signals: Optional[SignalRegistry] = None, recorder=None) -> None:
        self.store = store
        self.recorder = recorder  # an EventRecorder: the scaling events
        self.config = config or AutoscalerConfig()
        self.signals = signals or SignalRegistry(now_fn=store.clock)
        # serving key → the model label last exported on AUTOSCALER_REPLICAS,
        # so the series die with the ModelServing
        self._exported_models: Dict[str, str] = {}
        # the last DECISION_RECORDS decisions
        self.decisions: Deque[dict] = deque(maxlen=DECISION_RECORDS)

    # ------------------------------------------------------------ helpers

    def replica_pods(self, ms: ModelServing) -> List[Pod]:
        key = serving_key(ms)
        return [p for p in self.store.list("Pod", namespace=ms.namespace, copy=False)
                if p.labels.get(MODEL_SERVING_LABEL) == key]

    def _build_replica(self, ms: ModelServing, index: int) -> Pod:
        name = replica_name(ms.name, index)
        return Pod(name, ms.namespace,
                   request={mig_resource(ms.spec.slice_profile): 1},
                   labels={MODEL_SERVING_LABEL: serving_key(ms),
                           # each replica is a gang of one: replicas place
                           # independently, through the gang handshake
                           GANG_NAME_LABEL: name, GANG_SIZE_LABEL: "1"},
                   scheduler_name=ms.spec.scheduler_name)

    def _record(self, ms: ModelServing, decision: policy.Decision, current: int,
                now: float, created: int = 0, deleted: int = 0) -> None:
        self.decisions.append({
            "model_serving": f"{ms.namespace}/{ms.name}", "now": now,
            "verdict": decision.verdict, "reason": decision.reason,
            "current": current, "desired": decision.desired,
            "created": created, "deleted": deleted})

    # ------------------------------------------------- grace reservations

    def _reserve_nodes(self, ms: ModelServing, vacated: List[str], now: float) -> None:
        """One grace hold for each vacated replica (``vacated`` holds the
        node of each), added beside the holds a node already carries."""
        if ms.spec.cold_start_grace_seconds <= 0:
            return
        until = now + ms.spec.cold_start_grace_seconds
        fresh = GraceHold(serving_key(ms), ms.spec.chips_per_replica, until)
        per_node = Counter(n for n in vacated if n)
        for node_name in sorted(per_node):
            node = self.store.try_get("Node", node_name, copy=False)
            if node is None or node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
                continue  # gone (mid re-carve), or not a MIG node

            def add(obj, count=per_node[node_name]) -> None:
                holds = grace_holds(obj.annotations, node_memory_slices(obj))
                _merge_annotations(obj, grace_hold_patch(holds + [fresh] * count))

            try:
                self.store.patch_merge("Node", node_name, "", add)
            except NotFoundError:
                continue

    def _sweep_reservations(self, ms: ModelServing, now: float, release_all: bool) -> None:
        """Clear this model's grace holds whose own expiry has passed (all
        of them with ``release_all``); other models' holds stay."""
        key = serving_key(ms)

        def expired(hold: GraceHold) -> bool:
            return hold.holder == key and (release_all or now >= hold.until)

        for node in self.store.list("Node", copy=False):
            holds = grace_holds(node.annotations, node_memory_slices(node))
            if not any(expired(h) for h in holds):
                continue

            def sweep(obj) -> None:
                left = [h for h in grace_holds(obj.annotations, node_memory_slices(obj))
                        if not expired(h)]
                _merge_annotations(obj, grace_hold_patch(left))

            try:
                self.store.patch_merge("Node", node.name, "", sweep)
            except NotFoundError:
                continue

    # ----------------------------------------------------------- reconcile

    def step(self) -> int:
        """Reconcile every ModelServing, then collect the replicas whose
        ModelServing is gone; the requests reconciled."""
        servings = self.store.list("ModelServing", copy=False)
        for ms in servings:
            self.reconcile(ms.name, ms.namespace)
        live = {(ms.name, ms.namespace) for ms in servings}
        gone = {req for p in self.store.list("Pod", copy=False)
                for req in pod_to_serving_requests(p)}
        for key in self._exported_models:
            namespace, _, name = key.partition(".")
            gone.add((name, namespace))
        gone -= live
        for name, namespace in sorted(gone):
            self.reconcile(name, namespace)
        return len(servings) + len(gone)

    def reconcile(self, name: str, namespace: str) -> None:
        """The reference's reconcile of one request (its requeue has no
        taker here: the loop polls)."""
        ms = self.store.try_get("ModelServing", name, namespace)
        if ms is None:
            self._collect_orphans(name, namespace)
            return
        with TRACER.span("autoscaler.reconcile", model_serving=f"{namespace}/{name}"):
            self._reconcile(ms)

    def reconcile_request(self, req: Request) -> Optional[Result]:
        """``reconcile`` on a watch's request, resynced every
        ``resync_seconds`` while the ModelServing lives."""
        self.reconcile(req.name, req.namespace)
        if self.store.try_get("ModelServing", req.name, req.namespace, copy=False) is None:
            return None
        return Result(requeue_after=self.config.resync_seconds)

    def _collect_orphans(self, name: str, namespace: str) -> None:
        """A deleted ModelServing's replicas do not outlive it."""
        key = f"{namespace}.{name}"
        for p in self.store.list("Pod", namespace=namespace, copy=False):
            if p.labels.get(MODEL_SERVING_LABEL) == key:
                try:
                    self.store.delete("Pod", p.name, p.namespace)
                except NotFoundError:
                    pass
        model = self._exported_models.pop(key, None)
        if model is not None:
            for state in ("desired", "ready"):
                metrics.AUTOSCALER_REPLICAS.remove(model=model, state=state)

    def _reconcile(self, ms: ModelServing) -> None:
        now = self.signals.now()
        sig = self.signals.get(ms.spec.model)
        live = self.replica_pods(ms)
        current = len(live)
        ready = sum(1 for p in live if p.node)

        decision = policy.decide(ms.spec, current, sig, self.config, now,
                                 last_transition_t=ms.status.last_transition_t)
        metrics.AUTOSCALER_DECISIONS.labels(verdict=decision.verdict).inc()
        metrics.AUTOSCALER_REPLICAS.labels(model=ms.spec.model, state="desired").set(
            decision.desired)
        metrics.AUTOSCALER_REPLICAS.labels(model=ms.spec.model, state="ready").set(ready)
        self._exported_models[serving_key(ms)] = ms.spec.model

        cold_starting = decision.verdict == policy.VERDICT_COLD_START
        created = deleted = 0
        if decision.desired > current:
            created = self._scale_up(ms, live, decision)
        elif decision.desired < current:
            deleted = self._scale_down(ms, live, decision, now)
        if decision.desired != current or decision.verdict != policy.VERDICT_HOLD:
            self._record(ms, decision, current, now, created, deleted)

        # grace reservations: released when demand returns (the cold start
        # lands on the still-carved nodes), else expired on their clock
        self._sweep_reservations(ms, now, release_all=cold_starting or decision.desired > 0)
        self._update_status(ms, decision, now)

    def _scale_up(self, ms: ModelServing, live: List[Pod], decision: policy.Decision) -> int:
        have = {p.name for p in live}
        created = 0
        for i in range(decision.desired):
            name = replica_name(ms.name, i)
            if name in have:
                continue
            if len(have) + created >= decision.desired:
                break
            try:
                self.store.create(self._build_replica(ms, i))
            except AlreadyExistsError:
                log.debug("replica %s already exists", name)
                continue
            created += 1
        if created and self.recorder is not None:
            from nos_tpu_torch.api.v1alpha1.constants import (
                EVENT_REASON_COLD_START,
                EVENT_REASON_SCALED_UP,
            )

            if decision.verdict == policy.VERDICT_COLD_START:
                self.recorder.record(ms, EVENT_REASON_COLD_START,
                                     f"cold start: {decision.reason}; created {created} "
                                     f"replica(s) of {ms.spec.model}")
            self.recorder.record(ms, EVENT_REASON_SCALED_UP,
                                 f"{decision.reason}: replicas {len(live)} -> "
                                 f"{decision.desired} ({ms.spec.slice_profile} x {created} "
                                 "created)")
        return created

    def _scale_down(self, ms: ModelServing, live: List[Pod], decision: policy.Decision,
                    now: float) -> int:
        doomed = live[decision.desired:]  # by name: the top first out
        vacated = [p.node for p in doomed]
        for p in doomed:
            try:
                self.store.delete("Pod", p.name, p.namespace)
            except NotFoundError:
                continue
        if decision.desired == 0:
            self._reserve_nodes(ms, vacated, now)
        if self.recorder is not None:
            from nos_tpu_torch.api.v1alpha1.constants import (
                EVENT_REASON_SCALED_DOWN,
                EVENT_REASON_SCALED_TO_ZERO,
            )

            if decision.desired == 0:
                self.recorder.record(
                    ms, EVENT_REASON_SCALED_TO_ZERO,
                    f"{decision.reason}: released {len(doomed)} replica(s), "
                    f"{ms.spec.chips_per_replica * len(doomed)} memory slices held in "
                    f"{ms.spec.cold_start_grace_seconds:.0f}s cold-start grace")
            else:
                self.recorder.record(ms, EVENT_REASON_SCALED_DOWN,
                                     f"{decision.reason}: replicas {len(live)} -> "
                                     f"{decision.desired}")
        return len(doomed)

    def _update_status(self, ms: ModelServing, decision: policy.Decision, now: float) -> None:
        live = self.replica_pods(ms)
        replicas = len(live)
        ready_now = sum(1 for p in live if p.node)
        status = ms.status
        transition = decision.desired != status.desired_replicas
        cold_start_since = status.cold_start_since
        cold_starts = status.cold_starts
        if decision.verdict == policy.VERDICT_COLD_START and transition:
            cold_start_since = now
            cold_starts += 1
        elif cold_start_since > 0 and ready_now > 0:
            metrics.AUTOSCALER_COLD_START_SECONDS.observe(now - cold_start_since)
            cold_start_since = 0.0

        if (not transition and status.replicas == replicas
                and status.ready_replicas == ready_now
                and status.last_verdict == decision.verdict
                and status.cold_start_since == cold_start_since
                and status.cold_starts == cold_starts):
            return

        def mutate(obj: ModelServing) -> None:
            obj.status.replicas = replicas
            obj.status.ready_replicas = ready_now
            obj.status.desired_replicas = decision.desired
            obj.status.last_verdict = decision.verdict
            if transition:
                obj.status.last_transition_t = now
            obj.status.cold_start_since = cold_start_since
            obj.status.cold_starts = cold_starts

        try:
            self.store.patch_merge("ModelServing", ms.name, ms.namespace, mutate)
        except NotFoundError:
            pass

    # -------------------------------------------------------------- debug

    def debug_payload(self) -> dict:
        servings = {}
        for ms in self.store.list("ModelServing", copy=False):
            live = self.replica_pods(ms)
            servings[f"{ms.namespace}/{ms.name}"] = {
                "model": ms.spec.model,
                "slice_profile": ms.spec.slice_profile,
                "chips_per_replica": ms.spec.chips_per_replica,
                "bounds": [ms.spec.min_replicas, ms.spec.max_replicas],
                "replicas": len(live),
                "ready_replicas": sum(1 for p in live if p.node),
                "desired_replicas": ms.status.desired_replicas,
                "last_verdict": ms.status.last_verdict,
                "cold_starts": ms.status.cold_starts,
            }
        return {"servings": servings, "signals": self.signals.payload()}
