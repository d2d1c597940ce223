"""The quotas' validating webhooks.

Counterpart of ``nos_tpu/controllers/elasticquota/webhooks.py`` (reference
pkg/api/nos.nebuly.com/v1alpha1/elasticquota_webhook.go:31-97 and
compositeelasticquota_webhook.go): one ElasticQuota a namespace, none in
a namespace a CompositeElasticQuota covers, no two composite quotas over
one namespace, and ``min`` ≤ ``max`` where both name a resource. They
run on the port's store (``NodeStore.register_admission``), before
every create and patch of a quota.
"""
from __future__ import annotations

from nos_tpu_torch.kube.store import AdmissionError, NodeStore


def _validate_min_max(quota) -> None:
    for name, min_qty in quota.min.items():
        if name in quota.max and quota.max[name] < min_qty:
            raise AdmissionError(f"spec.max[{name}]={quota.max[name]} is below spec.min={min_qty}")


def validate_elastic_quota(quota, store: NodeStore) -> None:
    _validate_min_max(quota)
    ns = quota.namespace
    for existing in store.list("ElasticQuota", namespace=ns):
        if existing.name != quota.name:
            raise AdmissionError(f"namespace {ns} already has ElasticQuota {existing.name}")
    for ceq in store.list("CompositeElasticQuota"):
        if ns in ceq.namespaces:
            raise AdmissionError(f"namespace {ns} is covered by CompositeElasticQuota {ceq.name}")


def validate_composite_elastic_quota(quota, store: NodeStore) -> None:
    _validate_min_max(quota)
    for other in store.list("CompositeElasticQuota"):
        if other.name == quota.name and other.namespace == quota.namespace:
            continue
        overlap = set(other.namespaces) & set(quota.namespaces)
        if overlap:
            raise AdmissionError(f"namespaces {sorted(overlap)} already covered by "
                                 f"CompositeElasticQuota {other.name}")


def register_elasticquota_webhooks(store: NodeStore) -> None:
    store.register_admission("ElasticQuota", validate_elastic_quota)
    store.register_admission("CompositeElasticQuota", validate_composite_elastic_quota)
