"""A trimmed node store: the part of ``nos_tpu/kube/store.py`` the node
agents and the partitioners call.

The port has no kube object model (``gpu/node.py``): a node is its name,
labels, capacity, allocatable and annotations; a pod its name,
namespace, node, phase and request ``{resource: quantity}``; a config map
its name, namespace and string data. ``NodeStore`` keeps them under one
lock, with the reference's verbs: ``create``, ``get`` / ``try_get``,
``delete``, ``list``, ``patch_merge`` (a mutate callable run under the
lock on a copy, then stored) and ``patch_annotations`` /
``patch_labels`` (a ``None`` value deletes the key). Objects are copied
on the way in and out, so mutating a returned object never mutates the
store. There are no watches and no resource versions: the agents poll
(``controllers/migagent``).
"""
from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    capacity: Dict[str, int] = field(default_factory=dict)
    allocatable: Dict[str, int] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    namespace: str = ""  # nodes are cluster-scoped


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    node: str = ""
    phase: str = PodPhase.PENDING
    request: Dict[str, int] = field(default_factory=dict)


@dataclass
class ConfigMap:
    name: str
    namespace: str = ""
    data: Dict[str, str] = field(default_factory=dict)


_KINDS = {"Node": Node, "Pod": Pod, "ConfigMap": ConfigMap}


def _kind(obj: Any) -> str:
    for name, cls in _KINDS.items():
        if isinstance(obj, cls):
            return name
    raise TypeError(f"the store keeps nodes, pods and config maps, not {type(obj).__name__}")


class NodeStore:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str, str], Any] = {}

    def create(self, obj: Any) -> Any:
        key = (_kind(obj), obj.namespace, obj.name)
        with self._lock:
            if key in self._objects:
                raise AlreadyExistsError(f"{key[0]} {obj.namespace}/{obj.name} exists")
            self._objects[key] = copy.deepcopy(obj)
        return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        obj = self.try_get(kind, name, namespace)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return obj

    def try_get(self, kind: str, name: str, namespace: str = "") -> Optional[Any]:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def delete(self, kind: str, name: str, namespace: str = "") -> Any:
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return obj

    def list(self, kind: str = "Pod") -> List[Any]:
        """Every object of ``kind``, by namespace and name."""
        with self._lock:
            return [copy.deepcopy(obj) for key, obj in sorted(self._objects.items())
                    if key[0] == kind]

    def patch_merge(self, kind: str, name: str, namespace: str,
                    mutate: Callable[[Any], None]) -> Any:
        """Read-modify-write under the store's lock (a merge patch)."""
        key = (kind, namespace, name)
        with self._lock:
            if key not in self._objects:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            obj = copy.deepcopy(self._objects[key])
            mutate(obj)
            self._objects[key] = obj
            return copy.deepcopy(obj)

    @staticmethod
    def _merge(target: Dict[str, str], patch: Dict[str, Optional[str]]) -> None:
        for k, v in patch.items():
            if v is None:
                target.pop(k, None)
            else:
                target[k] = v

    def patch_annotations(self, kind: str, name: str, namespace: str,
                          annotations: Dict[str, Optional[str]]) -> Any:
        return self.patch_merge(kind, name, namespace,
                                lambda obj: self._merge(obj.annotations, annotations))

    def patch_labels(self, kind: str, name: str, namespace: str,
                     labels: Dict[str, Optional[str]]) -> Any:
        return self.patch_merge(kind, name, namespace,
                                lambda obj: self._merge(obj.labels, labels))
