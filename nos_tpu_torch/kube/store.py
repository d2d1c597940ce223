"""The node store: counterpart of ``nos_tpu/kube/store.py``'s ``KubeStore``.

Keeps the flat objects of ``kube/objects.py`` (re-exported here), the
elastic quotas and the ModelServing under one lock, with the reference's
verbs: ``create`` (which stamps a fresh ``uid`` on every pod, and its
``created`` from the store's clock when the caller left it unset),
``get`` / ``try_get``, ``update`` (a replace; with ``check_version`` a
stale ``resource_version`` raises ``ConflictError``, ``:235-250``),
``delete``, ``list``, ``patch_merge`` (a mutate callable run under the
lock on a copy, then stored), ``apply`` (a replica's create-or-replace, as
given), ``apply_event`` (a watch event replayed verbatim, ``:275-289``:
what ``KubeApiStore``'s reflectors apply) and ``patch_annotations`` /
``patch_labels`` (a ``None`` value deletes the key). Objects are copied on
the way in and out, so mutating a returned object never mutates the store
(``list``, ``try_get`` and ``list_by_index`` take ``copy=False`` for
read-only callers: every write stores a new object and none is changed
in place). ``register_admission(kind, fn)`` adds an admission webhook:
``fn(obj, store)`` runs before ``create``, ``update`` and ``patch_merge``
store the object; it may mutate it (a mutating webhook) or raise
``AdmissionError`` to refuse it.

``revision`` counts the writes this store applied (the reference's
``KubeApiStore.revision``, its apply sequence; the journal needs one
step a write). Each write the store makes itself stamps the object's
``resource_version`` with one more than ``version``, the highest
version stamped or applied, as the reference's in-memory store stamps
(``apply`` and ``apply_event`` keep the version they are given and raise
``version`` to it; a delete stamps the departing object, on a copy). On
a store no one replays into, ``version == revision``. ``pods_by_node``
is memoized on ``revision``: the live pods bound to each node. ``hold()``
is the lock as a context, for a reader that must see one revision.

Watches (``:400-465``): ``watch(kinds, name)`` returns a queue that
first replays every existing object of ``kinds`` as ADDED, in sorted
(kind, namespace, name) order, then receives a ``WatchEvent`` (type,
object, the store's revision) for each write, in write order: the
events are queued under the store's lock. A watch event carries the
stored object itself (read-only, as ``copy=False``), a deleted object
with its deletion version. ``stop_watch`` ends one, ``watch_stats``
gives each subscriber's depth. Indexers (``:186-205``, ``:362-398``):
``add_indexer(kind, name, fn)`` keeps a map from each value ``fn(obj)``
lists to its objects, in step with every write, and ``list_by_index``
answers from it; ``INDEX_POD_NODE`` and ``INDEX_POD_PHASE`` are the
reference's names (``nos_tpu/api/v1alpha1/constants.py:53-54``). The
lock meters its contention (``STORE_LOCK_CONTENTION`` / ``_WAIT``), each
watch its queue depth (``WATCH_QUEUE_DEPTH``); the events queued on
every watch, summed, are the health timeline's
``size.kube.watch_queue_events`` (the newest store's, replace-by-name),
whose leak detector catches a consumer that never drains. The
reference's chaos seam waits for item 18b.3.

The change journal stands in for the watch deltas the reference's
incremental snapshot maintainer and capacity ledger drain
(``nos_tpu/controllers/partitioner/incremental.py``,
``nos_tpu/capacity/ledger.py``): every write appends a ``Change`` (its
revision, kind, namespace and name, ADDED / MODIFIED / DELETED, for a pod
the node it was bound to before and after, for a quota whether its spec
moved or only its status, and the object as the write stored it, None
for a delete), ``JOURNAL_LENGTH`` of them at most.
``changes_since(revision)`` gives the changes after a reader's cursor, or
None when some of them have been dropped (the reader rebuilds, as on the
reference's drain overflow).
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Set, Tuple

from nos_tpu_torch.api.v1alpha1.constants import INDEX_POD_NODE, INDEX_POD_PHASE  # noqa: F401
from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.v1alpha1.modelserving import ModelServing
from nos_tpu_torch.kube.objects import (  # noqa: F401  (the store's names)
    ConfigMap,
    Event,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    OwnerReference,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    PodPhase,
    Service,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from nos_tpu_torch.timeline.sizes import SIZES
from nos_tpu_torch.util import metrics

log = logging.getLogger("nos_tpu_torch.kube.store")

_deepcopy = copy.deepcopy  # list()'s ``copy`` argument shadows the module

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class AdmissionError(ValueError):
    """A validating webhook refused the object."""


class ConflictError(RuntimeError):
    """A write carried a stale resource version."""


_uids = itertools.count(1)
_uid_lock = threading.Lock()


def _new_uid() -> str:
    with _uid_lock:
        return f"uid-{next(_uids)}"


_KINDS = {"Node": Node, "Pod": Pod, "ConfigMap": ConfigMap, "ElasticQuota": ElasticQuota,
          "CompositeElasticQuota": CompositeElasticQuota,
          "PodDisruptionBudget": PodDisruptionBudget, "Service": Service,
          "ModelServing": ModelServing, "Event": Event}


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Any  # read-only
    # the store's revision after the write (a replay: its revision then)
    revision: int = 0
    # monotonic time it was queued; consumers observe the drain lag
    enqueued: float = 0.0

    @property
    def kind(self) -> str:
        return self.object.kind


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
    # the object as stored by the write (None: deleted); read-only
    obj: Any = field(default=None, compare=False, repr=False)


def _quota_spec(obj: Any) -> tuple:
    return (tuple(sorted(obj.min.items())), tuple(sorted(obj.max.items())),
            tuple(getattr(obj, "namespaces", ())))


def _change(revision: int, kind: str, before: Any, after: Any) -> Change:
    obj = after if after is not None else before
    kind_of_write = ADDED if before is None else DELETED if after is None else MODIFIED
    spec_changed = True
    if kind in ("ElasticQuota", "CompositeElasticQuota") and before is not None \
            and after is not None:
        spec_changed = _quota_spec(before) != _quota_spec(after)
    node_of = (lambda o: o.node if o is not None else "") if kind == "Pod" else (lambda o: "")
    return Change(revision, kind, obj.namespace, obj.name, kind_of_write, node_of(before),
                  node_of(after), spec_changed, after)


def _kind(obj: Any) -> str:
    kind = getattr(type(obj), "kind", None)
    if _KINDS.get(kind) is not type(obj):
        raise TypeError(f"the store keeps {', '.join(_KINDS)}, not {type(obj).__name__}")
    return kind


class _InstrumentedLock:
    """A re-entrant lock that meters contended acquisitions: the
    uncontended path costs one non-blocking try; a caller that blocks
    lands its wait in ``STORE_LOCK_WAIT``."""

    __slots__ = ("_lock",)

    def __init__(self) -> None:
        self._lock = threading.RLock()

    def __enter__(self) -> "_InstrumentedLock":
        if not self._lock.acquire(blocking=False):
            start = time.perf_counter()
            self._lock.acquire()
            metrics.STORE_LOCK_CONTENTION.inc()
            metrics.STORE_LOCK_WAIT.inc(time.perf_counter() - start)
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()


@dataclass
class _Watcher:
    kind_set: Optional[Set[str]]
    queue: "queue.Queue[WatchEvent]"
    label: str
    depth_gauge: Any
    last_warn: float = 0.0


Key = Tuple[str, str, str]


class NodeStore:
    # a subscriber whose queue grows past this gets a rate-limited warning
    WATCH_QUEUE_WARN_DEPTH = 1000
    WATCH_QUEUE_WARN_INTERVAL = 30.0

    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self._lock = _InstrumentedLock()
        self._objects: Dict[Key, Any] = {}
        # kind → the (namespace, name) keys of its objects, sorted, rebuilt
        # after a create or delete of that kind (None: stale)
        self._sorted_keys: Dict[str, Optional[List[Tuple[str, str]]]] = {}
        # the clock pods' creation times are read from; a caller on
        # virtual time passes its own
        self.clock = clock
        # kind → [fn(obj, store)], run before create / update / patch_merge
        self._admission: Dict[str, List[Callable[[Any, "NodeStore"], None]]] = {}
        # bumped by every write
        self.revision = 0
        # the highest resource version stamped or applied: the next write
        # stamps one more
        self._version = 0
        self._journal: Deque[Change] = deque(maxlen=JOURNAL_LENGTH)
        self._pods_by_node: Optional[Tuple[int, Dict[str, List[Any]]]] = None
        self._watchers: List[_Watcher] = []
        # (kind, index) → fn, and (kind, index) → value → keys
        self._indexers: Dict[Tuple[str, str], Callable[[Any], List[str]]] = {}
        self._index_maps: Dict[Tuple[str, str], Dict[str, Set[Key]]] = {}
        SIZES.register("kube.watch_queue_events",
                       lambda: sum(w.queue.qsize() for w in list(self._watchers)))

    def register_admission(self, kind: str, fn: Callable[[Any, "NodeStore"], None]) -> None:
        self._admission.setdefault(kind, []).append(fn)

    def _admit(self, kind: str, obj: Any) -> None:
        for fn in self._admission.get(kind, []):
            fn(obj, self)

    # ------------------------------------------------------------ writes

    def _commit(self, kind: str, key: Key, before: Any, after: Any,
                event_obj: Any = None) -> int:
        """One write under the lock: the object map, the indexes, the
        revision, the journal and the watchers; the new revision."""
        if after is None:
            self._objects.pop(key, None)
        else:
            self._objects[key] = after
        if before is None or after is None:
            self._sorted_keys[kind] = None
        self._index_update(key, before, after)
        obj = after if after is not None else event_obj
        if obj is not None and obj.resource_version > self._version:
            self._version = obj.resource_version
        self.revision += 1
        self._journal.append(_change(self.revision, kind, before, after))
        etype = ADDED if before is None else DELETED if after is None else MODIFIED
        self._notify(WatchEvent(etype, after if after is not None else event_obj,
                                self.revision))
        return self.revision

    def create(self, obj: Any) -> Any:
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        stored = _deepcopy(obj)
        with self._lock:
            if key in self._objects:
                raise AlreadyExistsError(f"{key[0]} {obj.namespace}/{obj.name} exists")
            if kind == "Pod":
                stored.uid = _new_uid()
                if stored.created is None:
                    stored.created = self.clock()
            self._admit(kind, stored)
            stored.resource_version = self._version + 1
            self._commit(kind, key, None, stored)
            return _deepcopy(stored)

    def update(self, obj: Any, check_version: bool = False) -> Any:
        """Replace the stored object with a copy of ``obj``; with
        ``check_version`` a resource version other than the stored one
        raises ``ConflictError``."""
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        stored = _deepcopy(obj)
        with self._lock:
            before = self._objects.get(key)
            if before is None:
                raise NotFoundError(f"{kind} {obj.namespace}/{obj.name} not found")
            if check_version and before.resource_version != obj.resource_version:
                raise ConflictError(f"{kind} {obj.namespace}/{obj.name}: resource version "
                                    f"conflict ({obj.resource_version} against "
                                    f"{before.resource_version})")
            self._admit(kind, stored)
            stored.resource_version = self._version + 1
            self._commit(kind, key, before, stored)
            return _deepcopy(stored)

    def apply(self, obj: Any, copy: bool = True) -> None:
        """Store a copy of ``obj`` as it is, created or replaced: no uid or
        version stamped and no admission run. A replica mirroring another
        store's objects (a pool worker's, ``partitioning/core/procpool.py``)
        writes this way, as a watch event would; ``copy=False`` stores
        ``obj`` itself, for a caller that hands it over and never changes
        it (an object just decoded from the wire)."""
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        stored = _deepcopy(obj) if copy else obj
        with self._lock:
            self._commit(kind, key, self._objects.get(key), stored)

    def apply_event(self, etype: str, obj: Any) -> None:
        """Replay a watch event verbatim: upsert or delete without
        re-stamping the version (a DELETED of a missing object is a
        no-op; an ADDED of a present one replaces it)."""
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        with self._lock:
            before = self._objects.get(key)
            if etype == DELETED:
                if before is not None:
                    self._commit(kind, key, before, None, event_obj=obj)
                return
            self._commit(kind, key, before, _deepcopy(obj))

    def delete(self, kind: str, name: str, namespace: str = "") -> Any:
        key = (kind, namespace, name)
        with self._lock:
            obj = self._objects.get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            # the departing object with its deletion version (a copy: the
            # stored one may be shared with read-only callers)
            gone = dataclasses.replace(obj, resource_version=self._version + 1)
            self._commit(kind, key, obj, None, event_obj=gone)
        return gone

    def patch_merge(self, kind: str, name: str, namespace: str,
                    mutate: Callable[[Any], None]) -> Any:
        """Read-modify-write under the store's lock (a merge patch)."""
        key = (kind, namespace, name)
        with self._lock:
            before = self._objects.get(key)
            if before is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            obj = _deepcopy(before)
            mutate(obj)
            self._admit(kind, obj)
            obj.resource_version = self._version + 1
            self._commit(kind, key, before, obj)
            return _deepcopy(obj)

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

    def hold(self) -> "_InstrumentedLock":
        """The store's lock, as a context: while the caller holds it no
        other thread writes, so what it reads is the store at one
        revision (a decision reads its watermark and its inputs
        under it)."""
        return self._lock

    @property
    def version(self) -> int:
        """The highest resource version the store has stamped or applied
        (the reference's in-memory ``revision``)."""
        with self._lock:
            return self._version

    # ------------------------------------------------------------- reads

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

    # ---------------------------------------------------------- indexers

    def _index_update(self, key: Key, old: Any, new: Any) -> None:
        for (i_kind, i_name), fn in self._indexers.items():
            if i_kind != key[0]:
                continue
            old_values = list(fn(old)) if old is not None else []
            new_values = list(fn(new)) if new is not None else []
            if old_values == new_values:
                continue
            index = self._index_maps[(i_kind, i_name)]
            for value in old_values:
                keys = index.get(value)
                if keys is not None:
                    keys.discard(key)
                    if not keys:
                        del index[value]
            for value in new_values:
                index.setdefault(value, set()).add(key)

    def add_indexer(self, kind: str, index_name: str, fn: Callable[[Any], List[str]]) -> None:
        """Register an index, filled from the objects already stored."""
        with self._lock:
            self._indexers[(kind, index_name)] = fn
            index: Dict[str, Set[Key]] = {}
            self._index_maps[(kind, index_name)] = index
            for key, obj in self._objects.items():
                if key[0] == kind:
                    for value in fn(obj):
                        index.setdefault(value, set()).add(key)

    def has_indexer(self, kind: str, index_name: str) -> bool:
        with self._lock:
            return (kind, index_name) in self._indexers

    def list_by_index(self, kind: str, index_name: str, value: str,
                      copy: bool = True) -> List[Any]:
        """The objects whose index lists ``value``, by namespace and name
        (``copy=False``: read-only, as ``list``)."""
        with self._lock:
            if (kind, index_name) not in self._indexers:
                raise KeyError(f"no indexer {index_name!r} for kind {kind!r}")
            keys = sorted(self._index_maps[(kind, index_name)].get(value, ()))
            objs = [self._objects[k] for k in keys]
        return [_deepcopy(obj) for obj in objs] if copy else objs

    # ------------------------------------------------------------ watches

    def watch(self, kinds: Optional[Iterable[str]] = None,
              name: str = "") -> "queue.Queue[WatchEvent]":
        """Subscribe to the writes of ``kinds`` (None: every kind); the
        existing objects come first, as ADDED, by (kind, namespace, name).
        ``name`` labels the subscriber's depth gauge."""
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        kind_set = set(kinds) if kinds is not None else None
        label = name or ("*" if kind_set is None else "|".join(sorted(kind_set)))
        watcher = _Watcher(kind_set, q, label,
                           metrics.WATCH_QUEUE_DEPTH.labels(kind_set=label))
        with self._lock:
            now = time.monotonic()
            for key in sorted(self._objects):
                if kind_set is None or key[0] in kind_set:
                    q.put(WatchEvent(ADDED, self._objects[key], self.revision, now))
            self._watchers.append(watcher)
            watcher.depth_gauge.set(q.qsize())
        return q

    def stop_watch(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            for w in self._watchers:
                if w.queue is q:
                    w.depth_gauge.set(0)
            self._watchers = [w for w in self._watchers if w.queue is not q]

    def watch_stats(self) -> Dict[str, Dict[str, Any]]:
        """Subscriber label → {kinds, depth}."""
        with self._lock:
            watchers = list(self._watchers)
        return {w.label: {"kinds": sorted(w.kind_set) if w.kind_set is not None else ["*"],
                          "depth": w.queue.qsize()} for w in watchers}

    def _notify(self, event: WatchEvent) -> None:
        """Queue ``event`` to every subscriber of its kind (under the lock,
        so each queue sees the writes in revision order)."""
        if not self._watchers:
            return
        event.enqueued = time.monotonic()
        kind = event.kind
        for w in self._watchers:
            if w.kind_set is not None and kind not in w.kind_set:
                continue
            w.queue.put(event)
            depth = w.queue.qsize()
            w.depth_gauge.set(depth)
            if depth >= self.WATCH_QUEUE_WARN_DEPTH:
                now = time.monotonic()
                if now - w.last_warn >= self.WATCH_QUEUE_WARN_INTERVAL:
                    w.last_warn = now
                    log.warning("watch subscriber %r is %d events behind; its queue is "
                                "unbounded and grows until it drains", w.label, depth)
