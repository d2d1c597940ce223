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

A scale to zero stamps a cold-start grace reservation
(``gpu/annotations.py``: ``AUTOSCALER_RESERVED`` / ``_UNTIL``) on the
MIG nodes its replicas vacated: the capacity ledger books that idle time
to ``autoscaler-grace``, the scheduler's ``AutoscalerGraceScoring``
steers the model's cold start back there, and the reservation expires
on the reconciler's clock (the signal registry's ``now_fn``, which
defaults to the store's clock), so a held node cannot leak.

Polled, with no watches (ROADMAP.md, Queue 3): ``reconcile(name,
namespace)`` is the reference's reconcile of one request; ``step()``
reconciles every ModelServing, then collects the replicas of a deleted
one (the reference's pod watch maps them back, ``pod_to_serving_requests``,
kept as a function of a pod). There are no events: ``decisions`` keeps
the last ``DECISION_RECORDS`` decisions, as ``Scheduler.preemptions``
keeps preemptions. The status goes through ``NodeStore.patch_merge``.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.modelserving import MODEL_SERVING_LABEL, ModelServing
from nos_tpu_torch.controllers.autoscaler import policy
from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry
from nos_tpu_torch.gpu.annotations import AUTOSCALER_RESERVED, AUTOSCALER_RESERVED_UNTIL
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, mig_resource
from nos_tpu_torch.kube.store import AlreadyExistsError, NodeStore, NotFoundError, Pod
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.tracing import TRACER

log = logging.getLogger("nos_tpu_torch.autoscaler")

DECISION_RECORDS = 1024


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


class ModelServingReconciler:
    def __init__(self, store: NodeStore, config: Optional[AutoscalerConfig] = None,
                 signals: Optional[SignalRegistry] = None) -> None:
        self.store = store
        self.config = config or AutoscalerConfig()
        self.signals = signals or SignalRegistry(now_fn=store.clock)
        # serving key → the model label last exported on AUTOSCALER_REPLICAS,
        # so the series die with the ModelServing
        self._exported_models: Dict[str, str] = {}
        # the last DECISION_RECORDS decisions, in place of the events
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

    def _reserve_nodes(self, ms: ModelServing, node_names: List[str], now: float) -> None:
        if ms.spec.cold_start_grace_seconds <= 0:
            return
        until = now + ms.spec.cold_start_grace_seconds
        for node_name in sorted(set(n for n in node_names if n)):
            node = self.store.try_get("Node", node_name, copy=False)
            if node is None or node.labels.get(PARTITIONING_LABEL) != PARTITIONING_MIG:
                continue  # gone (mid re-carve), or not a MIG node
            try:
                self.store.patch_annotations("Node", node_name, "", {
                    AUTOSCALER_RESERVED: serving_key(ms),
                    AUTOSCALER_RESERVED_UNTIL: f"{until:.6f}"})
            except NotFoundError:
                continue

    def _sweep_reservations(self, ms: ModelServing, now: float, release_all: bool) -> None:
        """Clear this model's expired grace reservations (all of them with
        ``release_all``)."""
        key = serving_key(ms)
        for node in self.store.list("Node", copy=False):
            ann = node.annotations
            if ann.get(AUTOSCALER_RESERVED) != key:
                continue
            try:
                until = float(ann.get(AUTOSCALER_RESERVED_UNTIL, "0"))
            except ValueError:
                until = 0.0
            if release_all or now >= until:
                try:
                    self.store.patch_annotations("Node", node.name, "", {
                        AUTOSCALER_RESERVED: None, AUTOSCALER_RESERVED_UNTIL: None})
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
        return created

    def _scale_down(self, ms: ModelServing, live: List[Pod], decision: policy.Decision,
                    now: float) -> int:
        doomed = live[decision.desired:]  # by name: the top first out
        freed_nodes = [p.node for p in doomed]
        for p in doomed:
            try:
                self.store.delete("Pod", p.name, p.namespace)
            except NotFoundError:
                continue
        if decision.desired == 0:
            self._reserve_nodes(ms, freed_nodes, now)
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
