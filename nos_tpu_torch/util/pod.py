"""Pod predicates: counterpart of ``nos_tpu/util/pod.py`` (reference
pkg/util/pod/pod.go:15-88) on the flat pod, whose PodScheduled=False /
Unschedulable condition is its ``unschedulable`` flag and whose one owner
reference is ``owner``."""
from __future__ import annotations

from nos_tpu_torch.api.v1alpha1.elasticquota import CAPACITY_LABEL, CAPACITY_OVER_QUOTA

PENDING = "Pending"


def is_pending(pod) -> bool:
    return pod.phase == PENDING


def is_unschedulable(pod) -> bool:
    return is_pending(pod) and pod.unschedulable


def is_preempting(pod) -> bool:
    """A preemption nominated a node for the pod (pod.go:21)."""
    return bool(pod.nominated_node)


def is_owned_by_kind(pod, kind: str) -> bool:
    return pod.owner is not None and pod.owner.kind == kind


def is_owned_by_daemonset(pod) -> bool:
    return is_owned_by_kind(pod, "DaemonSet")


def is_owned_by_node(pod) -> bool:
    return is_owned_by_kind(pod, "Node")


def extra_resources_could_help_scheduling(pod) -> bool:
    """Re-partitioning could make the pod schedulable (pod.go:25-33): it
    is pending and unschedulable, not preempting its way onto a node, and
    not bound to its node by a daemonset or static-pod owner."""
    return (is_unschedulable(pod) and not is_preempting(pod)
            and not is_owned_by_daemonset(pod) and not is_owned_by_node(pod))


def is_over_quota(pod) -> bool:
    return pod.labels.get(CAPACITY_LABEL) == CAPACITY_OVER_QUOTA
