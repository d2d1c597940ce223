"""The autoscaler component: counterpart of ``nos_tpu/cmd/autoscaler.py:23-55``
(the suite's own closing of the serving loop; nos has no such binary).

The ModelServing reconciler on the ModelServing watch and on its replica
pods' events (``serving_requests_of``), resynced every
``resync_seconds``. In a process of its own its signal registry is fed
by nothing yet, so it holds each ModelServing at its bounds (the
registry's feeds are the SLO engine's and the router's, in process).
Its scaling events go through ``EventRecorder(component="nos-autoscaler")``
(the reference's ``:35``).
"""
from __future__ import annotations

from typing import Optional

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.modelserving import MODEL_SERVING_LABEL
from nos_tpu_torch.controllers.autoscaler import ModelServingReconciler, SignalRegistry
from nos_tpu_torch.controllers.autoscaler.controller import serving_requests_of
from nos_tpu_torch.kube.controller import Controller, Manager, Watch
from nos_tpu_torch.kube.events import EventRecorder


def build_autoscaler(manager: Manager, config: Optional[AutoscalerConfig] = None,
                     signals: Optional[SignalRegistry] = None) -> ModelServingReconciler:
    config = config or AutoscalerConfig()
    config.validate()
    store = manager.store
    reconciler = ModelServingReconciler(
        store, config, signals or SignalRegistry(now_fn=store.clock),
        recorder=EventRecorder(store, component="nos-autoscaler", clock=store.clock))
    manager.add(Controller("autoscaler", store, reconciler.reconcile_request, [
        Watch("ModelServing"),
        Watch("Pod", predicate=lambda e: MODEL_SERVING_LABEL in e.object.labels,
              mapper=serving_requests_of),
    ]))
    return reconciler


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch autoscaler``."""
    from nos_tpu_torch.cmd._component import run_component
    from nos_tpu_torch.cmd.run import configs_from

    def build(manager, config):
        return build_autoscaler(manager, configs_from(config).autoscaler or AutoscalerConfig())

    return run_component("autoscaler", build, argv, **run)
