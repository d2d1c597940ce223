"""The node store the port's agents and partitioners share: a trimmed
counterpart of ``nos_tpu/kube/`` (``store.py``)."""
from nos_tpu_torch.kube.store import (
    AdmissionError,
    AlreadyExistsError,
    ConfigMap,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeStore,
    NotFoundError,
    OwnerReference,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    PodPhase,
    Service,
    TopologySpreadConstraint,
)

__all__ = ["AdmissionError", "AlreadyExistsError", "ConfigMap", "Node",
           "NodeSelectorRequirement", "NodeSelectorTerm", "NodeStore", "NotFoundError",
           "OwnerReference", "Pod", "PodAffinityTerm", "PodDisruptionBudget", "PodPhase",
           "Service", "TopologySpreadConstraint"]
