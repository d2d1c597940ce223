"""The quota controller and its webhooks: counterpart of
``nos_tpu/controllers/elasticquota`` (polled, or on watches)."""
from nos_tpu_torch.controllers.elasticquota.controller import (
    CompositeElasticQuotaReconciler,
    ElasticQuotaController,
    ElasticQuotaReconciler,
    pod_to_quota_requests,
    quota_accounting,
    sort_pods_for_quota,
)
from nos_tpu_torch.controllers.elasticquota.webhooks import (
    register_elasticquota_webhooks,
    validate_composite_elastic_quota,
    validate_elastic_quota,
)

__all__ = ["CompositeElasticQuotaReconciler", "ElasticQuotaController",
           "ElasticQuotaReconciler", "pod_to_quota_requests", "quota_accounting",
           "register_elasticquota_webhooks", "sort_pods_for_quota",
           "validate_composite_elastic_quota", "validate_elastic_quota"]
