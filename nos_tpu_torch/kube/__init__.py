"""The port's kube substrate: a counterpart of ``nos_tpu/kube/`` on flat
objects (``objects.py``): the store with watches, versions and indexers
(``store.py``), the controller runtime (``controller.py``), the
Kubernetes wire (``serde.py``) and the flat wire of the pool workers
(``flatwire.py``), events (``events.py``), leader election
(``leaderelection.py``), the API client (``apiclient.py``) and the
API-backed store (``apistore.py``)."""
from nos_tpu_torch.kube.store import (
    ADDED,
    DELETED,
    INDEX_POD_NODE,
    INDEX_POD_PHASE,
    MODIFIED,
    AdmissionError,
    AlreadyExistsError,
    ConfigMap,
    ConflictError,
    Event,
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
    WatchEvent,
)

__all__ = ["ADDED", "DELETED", "INDEX_POD_NODE", "INDEX_POD_PHASE", "MODIFIED",
           "AdmissionError", "AlreadyExistsError", "ConfigMap", "ConflictError", "Event",
           "Node", "NodeSelectorRequirement", "NodeSelectorTerm", "NodeStore",
           "NotFoundError", "OwnerReference", "Pod", "PodAffinityTerm",
           "PodDisruptionBudget", "PodPhase", "Service", "TopologySpreadConstraint",
           "WatchEvent"]
