"""A trimmed node store: the part of ``nos_tpu/kube/store.py`` the node
agents and the partitioners call.

The port has no kube object model (``gpu/node.py``): a node is its name,
labels, capacity, allocatable and annotations, plus the taints and the
cordon the scheduler's filters read; a pod its name, namespace, node,
phase and request ``{resource: quantity}``, plus what the scheduler and
the planner read of ``nos_tpu/kube/objects.py``'s pod (priority, labels,
annotations, node selector, tolerations, scheduler name, uid, creation
time and nominated node; the required node affinity terms, pod affinity
and anti-affinity terms and topology spread constraints of ``:92-185``;
the owner reference, hostname, subdomain and env the multi-node expander
writes) and its PodScheduled=False / Unschedulable condition as a flag
and a message; a config map its name, namespace and string data; a pod
disruption budget its selector and one of ``min_available`` /
``max_unavailable`` (``nos_tpu/kube/objects.py:350-363``); a headless
service its selector and ports. The elastic quotas are
``api/v1alpha1/elasticquota.py``'s. All of them stay plain dataclasses,
and every new field defaults to "none". ``NodeStore`` keeps them under
one lock, with the
reference's verbs: ``create`` (which stamps a fresh ``uid`` on every pod,
and its ``created`` from the store's clock when the caller left it
unset), ``get`` / ``try_get``, ``delete``, ``list``,
``patch_merge`` (a mutate callable run under the lock on a copy, then
stored), ``apply`` (a replica's create-or-replace, as given) and ``patch_annotations`` / ``patch_labels`` (a ``None`` value
deletes the key). Objects are copied
on the way in and out, so mutating a returned object never mutates the
store (``list`` and ``try_get`` take ``copy=False`` for read-only
callers). ``revision`` counts the writes (a resource version of the whole
store, for readers that memoize on it; ``pods_by_node`` is one such, the
live pods bound to each node). ``register_admission(kind, fn)``
adds an admission webhook:
``fn(obj, store)`` runs before ``create`` and ``patch_merge`` store the
object; it may mutate the object (a mutating webhook) or raise
``AdmissionError`` to refuse it. There are no
watches and no resource versions: the agents poll
(``controllers/migagent``).

The change journal stands in for the watch deltas the reference's
incremental snapshot maintainer drains
(``nos_tpu/controllers/partitioner/incremental.py``): every write
appends a ``Change`` (its revision, kind, namespace and name, ADDED /
MODIFIED / DELETED, for a pod the node it was bound to before and
after, for a quota whether its spec moved or only its status),
``JOURNAL_LENGTH`` of them at most. ``changes_since(revision)`` gives
the changes after a reader's cursor, or None when some of them have
been dropped (the reader rebuilds, as on the reference's drain
overflow). Watches themselves wait for the kube substrate's slice.
"""
from __future__ import annotations

import copy
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota


_deepcopy = copy.deepcopy  # list()'s ``copy`` argument shadows the module


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class AdmissionError(ValueError):
    """A validating webhook refused the object."""


_uids = itertools.count(1)
_uid_lock = threading.Lock()


def _new_uid() -> str:
    with _uid_lock:
        return f"uid-{next(_uids)}"


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | NoExecute | PreferNoSchedule


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches every effect

    def tolerates(self, taint: Taint) -> bool:
        """core/v1 semantics: an empty key with Exists tolerates every
        taint; an empty effect matches every effect."""
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        return self.operator == "Exists" or self.value == taint.value


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    capacity: Dict[str, int] = field(default_factory=dict)
    allocatable: Dict[str, int] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    namespace: str = ""  # nodes are cluster-scoped
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False  # cordoned


@dataclass
class NodeSelectorRequirement:
    """A label requirement: In | NotIn | Exists | DoesNotExist | Gt | Lt
    (``nos_tpu/kube/objects.py:92``)."""

    key: str = ""
    operator: str = "In"
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        present = self.key in labels
        value = labels.get(self.key, "")
        if self.operator == "In":
            return present and value in self.values
        if self.operator == "NotIn":
            return not present or value not in self.values
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator in ("Gt", "Lt"):
            try:
                lhs, rhs = int(value), int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        return False


@dataclass
class NodeSelectorTerm:
    """An AND of requirements; a pod's required terms OR together."""

    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class PodAffinityTerm:
    """A required pod (anti-)affinity term: pods selected by matchLabels
    AND matchExpressions, in ``namespaces`` (empty: the owner's own), within
    a topology domain. A term with no selector selects no pod."""

    topology_key: str = ""
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    namespaces: List[str] = field(default_factory=list)

    def selects(self, pod_labels: Dict[str, str], pod_ns: str, own_ns: str) -> bool:
        if not self.match_labels and not self.match_expressions:
            return False
        if pod_ns not in (self.namespaces or [own_ns]):
            return False
        if not all(pod_labels.get(k) == v for k, v in self.match_labels.items()):
            return False
        return all(r.matches(pod_labels) for r in self.match_expressions)


@dataclass
class TopologySpreadConstraint:
    """DoNotSchedule is a filter, ScheduleAnyway a score; a constraint
    with no selector matches no pod."""

    topology_key: str = ""
    max_skew: int = 1
    when_unsatisfiable: str = "DoNotSchedule"  # DoNotSchedule | ScheduleAnyway
    match_labels: Dict[str, str] = field(default_factory=dict)

    def selects(self, labels: Dict[str, str]) -> bool:
        if not self.match_labels:
            return False
        return all(labels.get(k) == v for k, v in self.match_labels.items())


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    node: str = ""
    phase: str = PodPhase.PENDING
    request: Dict[str, int] = field(default_factory=dict)
    priority: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = ""
    # PodScheduled=False with reason Unschedulable, and the scheduler's
    # message: what the partitioner batches on
    unschedulable: bool = False
    unschedulable_message: str = ""
    # stamped by NodeStore.create: a fresh uid, and the creation time
    # (on the store's clock) unless the caller set one
    uid: str = ""
    created: Optional[float] = None
    # the node a preemption cleared for the pod (status.nominatedNodeName)
    nominated_node: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    # required node affinity: the node must match one term
    node_affinity: List[NodeSelectorTerm] = field(default_factory=list)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    owner: Optional[OwnerReference] = None
    hostname: str = ""
    subdomain: str = ""
    env: Dict[str, str] = field(default_factory=dict)

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ConfigMap:
    name: str
    namespace: str = ""
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class PodDisruptionBudget:
    """The policy/v1 subset the preemptor reads: a matchLabels selector and
    one of min_available / max_unavailable, as absolute counts."""

    name: str
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None


@dataclass
class Service:
    """A headless service: a stable DNS record per selected pod
    (``<hostname>.<name>.<namespace>.svc``)."""

    name: str
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)  # port name → number
    cluster_ip: str = "None"
    owner: Optional[OwnerReference] = None


_KINDS = {"Node": Node, "Pod": Pod, "ConfigMap": ConfigMap, "ElasticQuota": ElasticQuota,
          "CompositeElasticQuota": CompositeElasticQuota,
          "PodDisruptionBudget": PodDisruptionBudget, "Service": Service}


# the writes the journal keeps; a reader further behind rebuilds
JOURNAL_LENGTH = 10_000


@dataclass(frozen=True)
class Change:
    """One write, as a watch would deliver it."""

    revision: int
    kind: str
    namespace: str
    name: str
    type: str  # ADDED | MODIFIED | DELETED
    node_before: str = ""  # a pod's node before and after the write
    node_after: str = ""
    spec_changed: bool = True  # False: a quota write that moved only its status


def _quota_spec(obj: Any) -> tuple:
    return (tuple(sorted(obj.min.items())), tuple(sorted(obj.max.items())),
            tuple(getattr(obj, "namespaces", ())))


def _change(revision: int, kind: str, before: Any, after: Any) -> Change:
    obj = after if after is not None else before
    kind_of_write = "ADDED" if before is None else "DELETED" if after is None else "MODIFIED"
    spec_changed = True
    if kind in ("ElasticQuota", "CompositeElasticQuota") and before is not None \
            and after is not None:
        spec_changed = _quota_spec(before) != _quota_spec(after)
    node_of = (lambda o: o.node if o is not None else "") if kind == "Pod" else (lambda o: "")
    return Change(revision, kind, obj.namespace, obj.name, kind_of_write, node_of(before),
                  node_of(after), spec_changed)


def _kind(obj: Any) -> str:
    for name, cls in _KINDS.items():
        if isinstance(obj, cls):
            return name
    raise TypeError(f"the store keeps {', '.join(_KINDS)}, not {type(obj).__name__}")


class NodeStore:
    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str, str], Any] = {}
        # kind → the (namespace, name) keys of its objects, sorted, rebuilt
        # after a create or delete of that kind (None: stale)
        self._sorted_keys: Dict[str, Optional[List[Tuple[str, str]]]] = {}
        # the clock pods' creation times are read from; a caller on
        # virtual time passes its own
        self.clock = clock
        # kind → [fn(obj, store)], run before create / patch_merge store
        self._admission: Dict[str, List[Callable[[Any, "NodeStore"], None]]] = {}
        # bumped by every write
        self.revision = 0
        self._journal: Deque[Change] = deque(maxlen=JOURNAL_LENGTH)
        self._pods_by_node: Optional[Tuple[int, Dict[str, List[Any]]]] = None

    def register_admission(self, kind: str, fn: Callable[[Any, "NodeStore"], None]) -> None:
        self._admission.setdefault(kind, []).append(fn)

    def _admit(self, kind: str, obj: Any) -> None:
        for fn in self._admission.get(kind, []):
            fn(obj, self)

    def create(self, obj: Any) -> Any:
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        stored = copy.deepcopy(obj)
        with self._lock:
            if key in self._objects:
                raise AlreadyExistsError(f"{key[0]} {obj.namespace}/{obj.name} exists")
            if kind == "Pod":
                stored.uid = _new_uid()
                if stored.created is None:
                    stored.created = self.clock()
            self._admit(kind, stored)
            self._objects[key] = stored
            self._record(kind, None, stored)
            return copy.deepcopy(stored)

    def apply(self, obj: Any, copy: bool = True) -> None:
        """Store a copy of ``obj`` as it is, created or replaced: no uid
        stamped and no admission run. A replica mirroring another store's
        objects (a pool worker's, ``partitioning/core/procpool.py``) writes
        this way, as a watch event would; ``copy=False`` stores ``obj``
        itself, for a caller that hands it over and never changes it (an
        object just decoded from the wire)."""
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        stored = _deepcopy(obj) if copy else obj
        with self._lock:
            before = self._objects.get(key)
            self._objects[key] = stored
            self._record(kind, before, stored)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        obj = self.try_get(kind, name, namespace)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return obj

    def try_get(self, kind: str, name: str, namespace: str = "",
                copy: bool = True) -> Optional[Any]:
        """The object, or None; ``copy=False`` returns the stored object
        itself, for read-only callers (as ``list``)."""
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
        if obj is None or not copy:
            return obj
        return _deepcopy(obj)

    def delete(self, kind: str, name: str, namespace: str = "") -> Any:
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is not None:
                self._record(kind, obj, None)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return obj

    def list(self, kind: str = "Pod", namespace: Optional[str] = None,
             copy: bool = True) -> List[Any]:
        """Every object of ``kind`` (in ``namespace`` when one is given), by
        namespace and name. ``copy=False`` returns the stored objects
        themselves, for read-only callers: every write stores a new object
        and none is changed in place, so they stay as they were listed,
        but a caller must not change them."""
        with self._lock:
            keys = self._sorted_keys.get(kind)
            if keys is None:
                keys = sorted(key[1:] for key in self._objects if key[0] == kind)
                self._sorted_keys[kind] = keys
            objects = self._objects
            objs = [objects[(kind,) + key] for key in keys
                    if namespace is None or key[0] == namespace]
        return [_deepcopy(obj) for obj in objs] if copy else objs

    def patch_merge(self, kind: str, name: str, namespace: str,
                    mutate: Callable[[Any], None]) -> Any:
        """Read-modify-write under the store's lock (a merge patch)."""
        key = (kind, namespace, name)
        with self._lock:
            if key not in self._objects:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            before = self._objects[key]
            obj = copy.deepcopy(before)
            mutate(obj)
            self._admit(kind, obj)
            self._objects[key] = obj
            self._record(kind, before, obj)
            return copy.deepcopy(obj)

    def _record(self, kind: str, before: Any, after: Any) -> None:
        """One write: the revision and the journal (under the lock)."""
        if before is None or after is None:
            self._sorted_keys[kind] = None
        self.revision += 1
        self._journal.append(_change(self.revision, kind, before, after))

    def pods_by_node(self) -> Dict[str, List[Any]]:
        """node → its bound pods that are pending or running, as stored
        (read-only), by namespace and name; built once a revision."""
        with self._lock:
            memo = self._pods_by_node
            if memo is not None and memo[0] == self.revision:
                return memo[1]
            by_node: Dict[str, List[Any]] = {}
            for pod in self.list("Pod", copy=False):
                if pod.node and pod.phase in (PodPhase.PENDING, PodPhase.RUNNING):
                    by_node.setdefault(pod.node, []).append(pod)
            self._pods_by_node = (self.revision, by_node)
            return by_node

    def changes_since(self, revision: int) -> Optional[List[Change]]:
        """The changes after ``revision``, oldest first; None when the
        journal no longer holds them all."""
        with self._lock:
            if revision >= self.revision:
                return []
            if not self._journal or self._journal[0].revision > revision + 1:
                return None
            out = []
            for change in reversed(self._journal):
                if change.revision <= revision:
                    break
                out.append(change)
            out.reverse()
            return out

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
