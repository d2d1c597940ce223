"""The nos.nebuly.com/v1alpha1 kinds the port keeps: the elastic quotas
and ModelServing."""
from nos_tpu_torch.api.v1alpha1.elasticquota import (
    CAPACITY_IN_QUOTA,
    CAPACITY_LABEL,
    CAPACITY_OVER_QUOTA,
    RESOURCE_GPU_MEMORY,
    CompositeElasticQuota,
    ElasticQuota,
)
from nos_tpu_torch.api.v1alpha1.modelserving import (
    MODEL_SERVING_LABEL,
    ModelServing,
    ModelServingSpec,
    ModelServingStatus,
)

__all__ = ["CAPACITY_IN_QUOTA", "CAPACITY_LABEL", "CAPACITY_OVER_QUOTA",
           "MODEL_SERVING_LABEL", "RESOURCE_GPU_MEMORY", "CompositeElasticQuota", "ElasticQuota",
           "ModelServing", "ModelServingSpec", "ModelServingStatus"]
