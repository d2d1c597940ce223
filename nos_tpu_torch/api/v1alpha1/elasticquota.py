"""ElasticQuota and CompositeElasticQuota, and the names the quota slice
shares.

Counterpart of ``nos_tpu/api/v1alpha1/elasticquota.py`` (reference
pkg/api/nos.nebuly.com/v1alpha1/elasticquota_types.go:30-71 and
compositeelasticquota_types.go:29-66). ``min`` is the guaranteed quota,
``max`` the borrowing ceiling (empty: none); a namespace may run past
its ``min`` on quota other namespaces leave unused, and the pods that
do are labelled over-quota and may be preempted. The port has no kube
object model (``kube/store.py``), so each kind is one flat dataclass:
name, namespace, spec fields, and ``used`` from the status.

Quotas count H100 memory in GB under the aggregate resource
``nos.nebuly.com/gpu-memory``, as the reference nos does (SURVEY.md
§2.5: pkg/gpu/util/resource.go:60-86, v1alpha1/constants.go:25-27);
``util/resources.py:with_aggregate_gpu_memory`` adds it to a request.
The capacity label and its values are ``nos_tpu/api/v1alpha1/labels.py:14-16``'s.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Dict, List

# the aggregate resource quotas count H100 memory in (GB)
RESOURCE_GPU_MEMORY = "nos.nebuly.com/gpu-memory"

# written on running pods by the quota controller; the preemptor reads it
CAPACITY_LABEL = "nos.nebuly.com/capacity"
CAPACITY_IN_QUOTA = "in-quota"
CAPACITY_OVER_QUOTA = "over-quota"


@dataclass
class ElasticQuota:
    name: str
    namespace: str = "default"
    min: Dict[str, int] = field(default_factory=dict)
    max: Dict[str, int] = field(default_factory=dict)
    used: Dict[str, int] = field(default_factory=dict)  # status.used
    resource_version: int = 0
    kind: ClassVar[str] = "ElasticQuota"


@dataclass
class CompositeElasticQuota:
    """One quota over a list of namespaces; it shadows their
    ElasticQuotas."""

    name: str
    namespace: str = "default"
    namespaces: List[str] = field(default_factory=list)
    min: Dict[str, int] = field(default_factory=dict)
    max: Dict[str, int] = field(default_factory=dict)
    used: Dict[str, int] = field(default_factory=dict)
    resource_version: int = 0
    kind: ClassVar[str] = "CompositeElasticQuota"
