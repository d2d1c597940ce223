"""The operator component: counterpart of ``nos_tpu/cmd/operator.py:16-102``
(reference cmd/operator/operator.go:50-126).

The two quota controllers, each on its quota kind's watch and the pod
watch (``pod_to_quota_requests``; the composite one keeps only the
requests naming a CompositeElasticQuota), with the quota validators on
the store's admission seam. With ``webhook.enabled`` the process also
serves the TLS admission endpoint (``kube/webhook.py``) from the moment
it starts, not behind the lease: the webhook Service balances over
every replica, and one that refused connections would fail the
cluster's quota writes. Both reconcilers record the capacity-label
flips' events through one ``EventRecorder(component="nos-operator")``
and, given a ``flight_recorder``, their reconciles (the reference's
``:19-37``).
"""
from __future__ import annotations

from typing import Optional

from nos_tpu_torch.api.config import OperatorConfig
from nos_tpu_torch.controllers.elasticquota import (
    CompositeElasticQuotaReconciler,
    ElasticQuotaReconciler,
    pod_to_quota_requests,
    register_elasticquota_webhooks,
)
from nos_tpu_torch.kube.controller import Controller, Manager, Watch
from nos_tpu_torch.kube.events import EventRecorder


def build_operator(manager: Manager, config: Optional[OperatorConfig] = None,
                   flight_recorder=None) -> None:
    config = config or OperatorConfig()
    config.validate()
    store = manager.store
    register_elasticquota_webhooks(store)
    recorder = EventRecorder(store, component="nos-operator", clock=store.clock)
    eq = ElasticQuotaReconciler(store, config.gpu_memory_gb, recorder=recorder,
                                flight_recorder=flight_recorder)
    ceq = CompositeElasticQuotaReconciler(store, config.gpu_memory_gb, recorder=recorder,
                                          flight_recorder=flight_recorder)

    def composite_requests(event):
        return [r for r in pod_to_quota_requests(store, event)
                if store.try_get("CompositeElasticQuota", r.name, r.namespace, copy=False)]

    manager.add(Controller("elasticquota", store, eq.reconcile_request, [
        Watch("ElasticQuota"),
        Watch("Pod", mapper=lambda e: pod_to_quota_requests(store, e)),
    ]))
    manager.add(Controller("compositeelasticquota", store, ceq.reconcile_request, [
        Watch("CompositeElasticQuota"),
        Watch("Pod", mapper=composite_requests),
    ]))


def build(manager: Manager, config: dict) -> None:
    """The operator and, when asked, its webhook server."""
    from nos_tpu_torch.cmd.run import configs_from

    build_operator(manager, configs_from(config).operator)
    webhook_cfg = config.get("webhook") or {}
    if webhook_cfg.get("enabled", False):
        from nos_tpu_torch.kube.webhook import build_elasticquota_webhook_server

        server = build_elasticquota_webhook_server(
            manager.store, port=int(webhook_cfg.get("port", 9443)),
            host=webhook_cfg.get("host", "0.0.0.0"), cert_file=webhook_cfg.get("certFile", ""),
            key_file=webhook_cfg.get("keyFile", ""))
        server.start()
        manager.add_runnable(lambda: None, server.stop)


def main(argv=None, **run) -> int:
    """``python -m nos_tpu_torch operator``."""
    from nos_tpu_torch.cmd._component import run_component

    return run_component("operator", build, argv, **run)
