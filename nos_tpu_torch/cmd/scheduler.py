"""The scheduler component: counterpart of ``nos_tpu/cmd/scheduler.py:13-170``
(reference cmd/scheduler/scheduler.go:43-59).

``build_scheduler`` puts the port's ``Scheduler`` on three watches, as
the reference: the pending pods this scheduler owns (a foreign pod is
logged once, here, where the watch drops it: a manifest without the
scheduler's name would otherwise pend with no trace); a bound pod that
finished or went, which maps to every pending pod (a same-shaped pod
binds on the freed slice with no replan); and every node event, which
maps to every pending pod (new slices advertised). The port's
``Scheduler.reconcile`` returns the cycle's outcome; ``cycle_result``
maps it to the reference's requeue: a nomination retries after half of
``retry_seconds``, a failure, a wait in Permit and a member waiting for
its gang after ``retry_seconds``, a bind not at all. The
``reservation-janitor`` clears the drain reservations whose holder is
gone, on node and pod departure events and every half TTL while one is
held. The scheduler records its events through an
``EventRecorder(component="nos-scheduler")`` (``Scheduled``,
``FailedScheduling``, the preemptor's ``Preempted``) and, given a
``flight_recorder``, its cycles, with the session facts replay rebuilds
it from (its name and gang timeout; the reference's ``:17-40``).
"""
from __future__ import annotations

import logging
from typing import Optional

from nos_tpu_torch.api.config import SchedulerConfig
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Result, Watch
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.store import DELETED, PodPhase
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
from nos_tpu_torch.scheduler.scheduler import CycleOutcome, Scheduler, new_framework

log = logging.getLogger("nos_tpu_torch.scheduler")

# foreign pods logged before the memory of them is cleared
FOREIGN_LOG_LIMIT = 4096


def cycle_result(scheduler: Scheduler, req: Request, outcome: Optional[CycleOutcome],
                 retry_seconds: float) -> Optional[Result]:
    """The reference's ``Result`` for one reconcile's outcome."""
    if outcome is None:
        # a member waiting in Permit is retried, so its gang's timeout is seen
        waiting = f"{req.namespace}/{req.name}" in scheduler.assumed()
        return Result(requeue_after=retry_seconds) if waiting else None
    if outcome.decision == "nominate":
        return Result(requeue_after=retry_seconds / 2)
    if outcome.decision in ("fail", "wait"):
        return Result(requeue_after=retry_seconds)
    return None


def build_scheduler(manager: Manager, config: Optional[SchedulerConfig] = None,
                    capacity_ledger=None, flight_recorder=None) -> Scheduler:
    config = config or SchedulerConfig()
    config.validate()
    store = manager.store
    scheduler = Scheduler(store, new_framework(store, config.gang_wait_timeout_seconds),
                          scheduler_name=config.scheduler_name, interval=config.retry_seconds,
                          capacity_ledger=capacity_ledger,
                          recorder=EventRecorder(store, component="nos-scheduler",
                                                 clock=store.clock),
                          flight_recorder=flight_recorder)
    if flight_recorder is not None:
        flight_recorder.record_session_meta(
            scheduler_name=config.scheduler_name,
            gang_timeout_seconds=config.gang_wait_timeout_seconds)
    logged_foreign: set = set()

    def claim_or_log_foreign(pod) -> bool:
        if scheduler.responsible_for(pod):
            return True
        if pod.namespaced_name not in logged_foreign:
            if len(logged_foreign) >= FOREIGN_LOG_LIMIT:
                logged_foreign.clear()  # bounded: at worst a pod is logged again
            logged_foreign.add(pod.namespaced_name)
            log.info("scheduler: ignoring %s (schedulerName=%r, ours=%r)",
                     pod.namespaced_name, pod.scheduler_name, scheduler.scheduler_name)
        return False

    def pending_pod_requests():
        return [Request(p.name, p.namespace) for p in store.list("Pod", copy=False)
                if p.phase == PodPhase.PENDING and not p.node and scheduler.responsible_for(p)]

    def pod_freed_mapper(event):
        pod = event.object
        if pod.node and (event.type == DELETED
                         or pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)):
            return pending_pod_requests()
        return []

    def reconcile(req: Request) -> Optional[Result]:
        outcome = scheduler.reconcile(req.name, req.namespace)
        return cycle_result(scheduler, req, outcome, config.retry_seconds)

    manager.add(Controller("scheduler", store, reconcile, [
        Watch("Pod", predicate=lambda e: e.type != DELETED
              and e.object.phase == PodPhase.PENDING and claim_or_log_foreign(e.object)),
        Watch("Pod", mapper=pod_freed_mapper),
        Watch("Node", mapper=lambda e: pending_pod_requests()),
    ]))
    _add_reservation_janitor(manager, scheduler)
    return scheduler


def _add_reservation_janitor(manager: Manager, scheduler: Scheduler) -> None:
    reservation = scheduler.reservation
    if reservation is None:
        return
    sweep = [Request("sweep")]

    def janitor(req: Request) -> Optional[Result]:
        reservation.release_invalid()
        if reservation.any_reserved():
            # a valid reservation expires on the clock with no event of its own
            return Result(requeue_after=max(1.0, reservation.ttl / 2))
        return None

    def reserved_node_mapper(event):
        return sweep if RESERVED_FOR in event.object.annotations else []

    def pod_departed_mapper(event):
        if event.type == DELETED or event.object.phase != PodPhase.PENDING:
            return sweep
        return []

    manager.add(Controller("reservation-janitor", manager.store, janitor, [
        Watch("Node", mapper=reserved_node_mapper),
        Watch("Pod", mapper=pod_departed_mapper),
    ]))


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch scheduler``."""
    from nos_tpu_torch.cmd._component import run_component
    from nos_tpu_torch.cmd.run import configs_from

    return run_component("scheduler", lambda manager, config: build_scheduler(
        manager, configs_from(config).scheduler), argv, **run)
