"""The names the kube substrate reads: the pod indexers' keys, the
scheduler names and the event reasons.

Counterpart of the part of ``nos_tpu/api/v1alpha1/constants.py``
(``:47-88``) that is not about TPU resources; the port's H100 resource
and annotation names live in ``gpu/node.py`` and ``gpu/annotations.py``.
``EVENT_REASONS`` is the one vocabulary ``kube/events.py`` accepts.
"""

SCHEDULER_NAME = "nos-scheduler"
DEFAULT_SCHEDULER_NAME = "default-scheduler"

# the indexer keys (reference cmd/gpupartitioner/gpupartitioner.go:270-292)
INDEX_POD_PHASE = "status.phase"
INDEX_POD_NODE = "spec.nodeName"
INDEX_EQ_NAMESPACE = "spec.namespaces"

EVENT_REASON_FAILED_SCHEDULING = "FailedScheduling"
EVENT_REASON_SCHEDULED = "Scheduled"
EVENT_REASON_PREEMPTED = "Preempted"
EVENT_REASON_QUOTA_BORROWED = "QuotaBorrowed"
EVENT_REASON_QUOTA_RECLAIMED = "QuotaReclaimed"
EVENT_REASON_PARTITIONING_APPLIED = "PartitioningApplied"
EVENT_REASON_CARVE_FAILED = "CarveFailed"
EVENT_REASON_AUDIT_VIOLATION = "AuditViolation"
EVENT_REASON_SCALED_UP = "ScaledUp"
EVENT_REASON_SCALED_DOWN = "ScaledDown"
EVENT_REASON_SCALED_TO_ZERO = "ScaledToZero"
EVENT_REASON_COLD_START = "ColdStart"
EVENT_REASON_HEALTH_DEGRADED = "HealthDegraded"

EVENT_REASONS = (
    EVENT_REASON_FAILED_SCHEDULING,
    EVENT_REASON_SCHEDULED,
    EVENT_REASON_PREEMPTED,
    EVENT_REASON_QUOTA_BORROWED,
    EVENT_REASON_QUOTA_RECLAIMED,
    EVENT_REASON_PARTITIONING_APPLIED,
    EVENT_REASON_CARVE_FAILED,
    EVENT_REASON_AUDIT_VIOLATION,
    EVENT_REASON_SCALED_UP,
    EVENT_REASON_SCALED_DOWN,
    EVENT_REASON_SCALED_TO_ZERO,
    EVENT_REASON_COLD_START,
    EVENT_REASON_HEALTH_DEGRADED,
)
