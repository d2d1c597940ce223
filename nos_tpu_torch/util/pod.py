"""Pod predicates: the part of ``nos_tpu/util/pod.py`` (reference
pkg/util/pod/pod.go:15-88) the quota slice reads."""
from __future__ import annotations

from nos_tpu_torch.api.v1alpha1.elasticquota import CAPACITY_LABEL, CAPACITY_OVER_QUOTA


def is_preempting(pod) -> bool:
    """A preemption nominated a node for the pod (pod.go:21)."""
    return bool(pod.nominated_node)


def is_over_quota(pod) -> bool:
    return pod.labels.get(CAPACITY_LABEL) == CAPACITY_OVER_QUOTA
