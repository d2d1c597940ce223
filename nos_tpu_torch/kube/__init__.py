"""The node store the port's agents and partitioners share: a trimmed
counterpart of ``nos_tpu/kube/`` (``store.py``)."""
from nos_tpu_torch.kube.store import (
    AlreadyExistsError,
    ConfigMap,
    Node,
    NodeStore,
    NotFoundError,
    Pod,
    PodPhase,
)

__all__ = ["AlreadyExistsError", "ConfigMap", "Node", "NodeStore", "NotFoundError", "Pod",
           "PodPhase"]
