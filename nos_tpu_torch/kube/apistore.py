"""KubeApiStore: the node store's surface over a Kubernetes API server.

Counterpart of ``nos_tpu/kube/apistore.py`` (``:187-500``). A
``NodeStore`` whose cache is filled by one reflector thread a kind:
list, then watch from the list's resource version; a 410 Gone (the
server compacted past it) or a failed stream relists, with the capped,
seeded ``Backoff`` between attempts, and a watch window that closes
cleanly resumes from the last version seen. A relist diffs the cache
against the listed world: what vanished is deleted (stamped with the
list's version, the tightest bound on when), what is newer is replaced.
A kind the server does not serve (404 / 403 before its first sync) is
served empty and probed slowly. Reads (``get``, ``list``,
``list_by_index``, ``watch``) come from the cache, as the reference's
cached client; ``watch`` delivers what the reflectors and the write path
applied, and ``revision`` counts those applies (the server's versions
can reach the cache out of order; an object's own ``resource_version``
stays the server's).

Writes go over HTTP and return what the server stored, which the cache
applies at once (read your writes; the reflector's copy of the same
version is then skipped): ``create``, ``update`` (diff and patch:
fields outside the model survive; ``check_version`` refuses a stale
version), ``delete`` and ``patch_merge`` (GET, mutate, a minimal merge
patch carrying the live version, retried on 409). A diff is routed as a
real server demands: status through ``/status``, a pod's first node
through the ``binding`` subresource, the rest as one merge patch.
Admission webhooks run before a write leaves. ``raw_get`` /
``raw_create`` move whole wire documents.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List

from nos_tpu_torch.kube import serde
from nos_tpu_torch.kube.apiclient import ApiError, Backoff, KubeApiClient
from nos_tpu_torch.kube.store import (
    AdmissionError,
    AlreadyExistsError,
    ConflictError,
    NodeStore,
    NotFoundError,
    _kind,
)
from nos_tpu_torch.util import metrics

log = logging.getLogger("nos_tpu_torch.kube.apistore")

DEFAULT_KINDS = tuple(serde.RESOURCES)

# kinds whose status writes only through the /status subresource
STATUS_SUBRESOURCE = {"Pod", "Node", "PodDisruptionBudget", "ElasticQuota",
                      "CompositeElasticQuota"}

_MISSING = object()


def _overlay_containers(live_list, projected_list):
    """The projected containers with the live wire's unmodelled fields: a
    merge patch replaces a list whole, so a diff that names
    spec.containers carries the whole array, and this keeps what the
    projection does not model (volume mounts, probes, valueFrom env
    entries) from being wiped by the patch."""
    by_name = {c.get("name"): c for c in live_list or []}
    out = []
    for c in projected_list or []:
        base = dict(by_name.get(c.get("name"), {}))
        merged = {**base, **{k: v for k, v in c.items() if k != "env"}}
        if "env" in c or "env" in base:
            # env entries merge by name; a live valueFrom survives unless
            # the projection names the same variable
            projected_env = {e["name"]: e for e in c.get("env") or []}
            merged_env = []
            for entry in base.get("env") or []:
                override = projected_env.pop(entry["name"], None)
                merged_env.append(override if override is not None else entry)
            merged_env.extend(projected_env.values())
            if merged_env:
                merged["env"] = merged_env
            else:
                merged.pop("env", None)
        out.append(merged)
    return out


def _merge_diff(old: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """The least JSON merge patch that turns ``old`` into ``new``: both
    are ``serde.to_wire`` projections of one object, so the patch names
    only modelled fields and never clobbers what the server keeps beyond
    them."""
    diff: Dict[str, Any] = {}
    for k, v in new.items():
        ov = old.get(k, _MISSING)
        if ov is _MISSING:
            diff[k] = v
        elif isinstance(v, dict) and isinstance(ov, dict):
            sub = _merge_diff(ov, v)
            if sub:
                diff[k] = sub
        elif v != ov:
            diff[k] = v
    for k in old:
        if k not in new:
            diff[k] = None  # merge-patch deletion
    return diff


def _api_error_to_store(e: ApiError) -> Exception:
    if e.status == 404:
        return NotFoundError(str(e))
    if e.status == 409:
        if "AlreadyExists" in e.body or "already exists" in e.body:
            return AlreadyExistsError(str(e))
        return ConflictError(str(e))
    if e.status in (400, 403, 422):
        return AdmissionError(str(e))
    return e


class KubeApiStore(NodeStore):
    def __init__(self, client: KubeApiClient, kinds: Iterable[str] = DEFAULT_KINDS,
                 relist_backoff_s: float = 2.0, backoff_seed: int = 0) -> None:
        super().__init__()
        self._client = client
        self._kinds = tuple(kinds)
        # the cap of the reconnect backoff
        self._relist_backoff_s = relist_backoff_s
        self._backoff_seed = backoff_seed
        self._stop_informers = threading.Event()
        self._threads: List[threading.Thread] = []
        self._synced: Dict[str, threading.Event] = {k: threading.Event() for k in self._kinds}
        self.relists: Dict[str, int] = {k: 0 for k in self._kinds}

    # ------------------------------------------------------------ lifecycle

    def start(self, sync_timeout_s: float = 30.0) -> None:
        """One reflector a kind; returns once every kind has listed."""
        for kind in self._kinds:
            t = threading.Thread(target=self._reflector, args=(kind,),
                                 name=f"informer-{kind}", daemon=True)
            t.start()
            self._threads.append(t)
        deadline = time.monotonic() + sync_timeout_s
        for kind, ev in self._synced.items():
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not ev.wait(remaining):
                raise TimeoutError(f"informer for {kind} did not sync in {sync_timeout_s}s")

    def stop(self, timeout: float = 0.0) -> None:
        """Stop the reflectors; with ``timeout``, wait that long for their
        threads (a watch ends at its next event or bookmark)."""
        self._stop_informers.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))

    # ------------------------------------------------------------ reflector

    def _reflector(self, kind: str) -> None:
        path = serde.resource_path(kind)
        rv = ""  # the last version seen; empty: (re)list
        backoff = Backoff(base=min(0.1, self._relist_backoff_s), cap=self._relist_backoff_s,
                          seed=self._backoff_seed ^ zlib.crc32(kind.encode()))
        while not self._stop_informers.is_set():
            try:
                if not rv:
                    items, rv = self._client.list(path)
                    objs = []
                    for item in items:
                        item.setdefault("kind", kind)
                        objs.append(serde.from_wire(item))
                    try:
                        list_rv = int(rv or 0)
                    except ValueError:
                        list_rv = 0
                    self._replace_kind(kind, objs, list_rv)
                    self.relists[kind] += 1
                    self._synced[kind].set()
                    backoff.reset()
                for event in self._client.watch(path, rv, self._stop_informers):
                    etype = event.get("type")
                    wire = event.get("object") or {}
                    ev_rv = str((wire.get("metadata") or {}).get("resourceVersion", ""))
                    if ev_rv:
                        rv = ev_rv
                    if etype == "BOOKMARK":
                        continue
                    wire.setdefault("kind", kind)
                    obj = serde.from_wire(wire)
                    if etype == "DELETED":
                        self._apply_delete(obj)
                    else:
                        self._apply_upsert(obj)
                continue  # the window closed: resume from the last version
            except ApiError as e:
                if e.status == 410:  # compacted past our version: relist
                    log.info("informer %s: watch expired, relisting", kind)
                    metrics.WATCH_RECONNECTS.labels(kind=kind).inc()
                    rv = ""
                    continue
                if e.status in (403, 404) and not self._synced[kind].is_set():
                    log.warning("informer %s: kind unavailable (%s); serving empty and "
                                "retrying", kind, e.status)
                    self._synced[kind].set()
                    self._stop_informers.wait(max(self._relist_backoff_s, 15.0))
                    rv = ""
                    continue
                log.warning("informer %s: %s", kind, e)
                metrics.WATCH_RECONNECTS.labels(kind=kind).inc()
                rv = ""
            except Exception as e:  # noqa: BLE001 - a reflector survives
                if self._stop_informers.is_set():
                    return
                log.warning("informer %s: %s: %s", kind, type(e).__name__, e)
                metrics.WATCH_RECONNECTS.labels(kind=kind).inc()
                rv = ""
            self._stop_informers.wait(backoff.next())

    # ------------------------------------------------------- cache writes

    def _replace_kind(self, kind: str, objs: List[Any], list_rv: int = 0) -> None:
        """A (re)list: the cache's objects of ``kind`` := ``objs``."""
        with self._lock:
            fresh = {(kind, o.namespace, o.name): o for o in objs}
            for key in sorted(k for k in self._objects if k[0] == kind and k not in fresh):
                gone = self._objects[key]
                if list_rv > gone.resource_version:
                    gone = dataclasses.replace(gone, resource_version=list_rv)
                self._commit(kind, key, self._objects[key], None, event_obj=gone)
            for key in sorted(fresh):
                obj = fresh[key]
                old = self._objects.get(key)
                if old is None or old.resource_version < obj.resource_version:
                    self._commit(kind, key, old, obj)

    def _apply_upsert(self, obj: Any) -> None:
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        with self._lock:
            old = self._objects.get(key)
            if old is not None and old.resource_version >= obj.resource_version:
                return  # stale, or applied already by the write path
            self._commit(kind, key, old, copy.deepcopy(obj))

    def _apply_delete(self, obj: Any) -> Any:
        kind = _kind(obj)
        key = (kind, obj.namespace, obj.name)
        with self._lock:
            stored = self._objects.get(key)
            if stored is None:
                return None
            gone = dataclasses.replace(stored, resource_version=max(
                stored.resource_version, obj.resource_version))
            self._commit(kind, key, stored, None, event_obj=gone)
            return gone

    # ---------------------------------------------------------- write verbs

    def create(self, obj: Any) -> Any:
        kind = _kind(obj)
        self._admit(kind, obj)
        try:
            resp = self._client.create(serde.resource_path(kind, obj.namespace),
                                       serde.to_wire(obj))
        except ApiError as e:
            raise _api_error_to_store(e) from e
        resp.setdefault("kind", kind)
        stored = serde.from_wire(resp)
        self._apply_upsert(stored)
        return copy.deepcopy(stored)

    def update(self, obj: Any, check_version: bool = False) -> Any:
        """Replace the modelled projection of the object (a diff and a
        patch: fields outside the model survive)."""
        kind = _kind(obj)
        self._admit(kind, obj)
        path = serde.resource_path(kind, obj.namespace, obj.name)
        try:
            live_wire = self._client.get(path)
        except ApiError as e:
            raise _api_error_to_store(e) from e
        live_wire.setdefault("kind", kind)
        live = serde.from_wire(live_wire)
        if check_version and live.resource_version != obj.resource_version:
            raise ConflictError(f"{kind} {obj.namespace}/{obj.name}: resource version "
                                "conflict")
        diff = _merge_diff(serde.to_wire(live), serde.to_wire(obj))
        diff.get("metadata", {}) and diff["metadata"].pop("resourceVersion", None)
        return self._push_diff(kind, obj.namespace, obj.name, live, diff)

    def delete(self, kind: str, name: str, namespace: str = "") -> Any:
        try:
            resp = self._client.delete(serde.resource_path(kind, namespace, name))
        except ApiError as e:
            raise _api_error_to_store(e) from e
        # the deletion's version, which the server returns on the object
        try:
            deleted_rv = int((resp.get("metadata") or {}).get("resourceVersion", 0))
        except (AttributeError, TypeError, ValueError):
            deleted_rv = 0
        with self._lock:
            stored = self._objects.get((kind, namespace, name))
            if stored is None:
                return None
            return self._apply_delete(dataclasses.replace(stored,
                                                          resource_version=deleted_rv))

    def patch_merge(self, kind: str, name: str, namespace: str,
                    mutate: Callable[[Any], None], max_retries: int = 5) -> Any:
        """GET the live object, mutate a copy, send the least merge patch
        with the live version; a 409 starts over, ``max_retries`` times."""
        path = serde.resource_path(kind, namespace, name)
        last: Exception = ConflictError(f"{kind} {namespace}/{name}: retries exhausted")
        for _ in range(max_retries):
            try:
                live_wire = self._client.get(path)
            except ApiError as e:
                raise _api_error_to_store(e) from e
            live_wire.setdefault("kind", kind)
            live = serde.from_wire(live_wire)
            obj = copy.deepcopy(live)
            mutate(obj)
            self._admit(kind, obj)
            diff = _merge_diff(serde.to_wire(live), serde.to_wire(obj))
            diff.get("metadata", {}) and diff["metadata"].pop("resourceVersion", None)
            try:
                return self._push_diff(kind, namespace, name, live, diff)
            except ConflictError as e:
                last = e
        raise last

    def _push_diff(self, kind: str, namespace: str, name: str, live: Any,
                   diff: Dict[str, Any]) -> Any:
        path = serde.resource_path(kind, namespace, name)
        if not diff:
            self._apply_upsert(live)
            return copy.deepcopy(live)
        if kind == "Pod" and "containers" in (diff.get("spec") or {}):
            try:
                live_wire = self._client.get(path)
            except ApiError as e:
                raise _api_error_to_store(e) from e
            diff["spec"]["containers"] = _overlay_containers(
                (live_wire.get("spec") or {}).get("containers"), diff["spec"]["containers"])
        try:
            status_diff = diff.pop("status", None) if kind in STATUS_SUBRESOURCE else None
            # a pod's first node goes through the binding subresource:
            # spec.nodeName is immutable through a patch
            spec_diff = diff.get("spec") or {}
            node_name = spec_diff.get("nodeName")
            if kind == "Pod" and node_name and not live.node:
                spec_diff.pop("nodeName")
                if not spec_diff:
                    diff.pop("spec", None)
                self._client.create(f"{path}/binding", {
                    "apiVersion": "v1", "kind": "Binding",
                    "metadata": {"name": name, "namespace": namespace},
                    "target": {"apiVersion": "v1", "kind": "Node", "name": node_name}})
            if diff:
                meta = dict(diff.get("metadata") or {})
                meta["resourceVersion"] = str(live.resource_version)
                self._client.merge_patch(path, {**diff, "metadata": meta})
            if status_diff is not None:
                self._client.merge_patch(f"{path}/status", {"status": status_diff})
            refreshed_wire = self._client.get(path)
        except ApiError as e:
            raise _api_error_to_store(e) from e
        refreshed_wire.setdefault("kind", kind)
        refreshed = serde.from_wire(refreshed_wire)
        self._apply_upsert(refreshed)
        return copy.deepcopy(refreshed)

    # ------------------------------------------------------------- raw path

    def raw_get(self, kind: str, name: str, namespace: str = "") -> Dict[str, Any]:
        """The live wire document, whole."""
        try:
            return self._client.get(serde.resource_path(kind, namespace, name))
        except ApiError as e:
            raise _api_error_to_store(e) from e

    def raw_create(self, kind: str, wire: Dict[str, Any]) -> Any:
        """POST a wire document as it is; its projection lands in the cache."""
        namespace = (wire.get("metadata") or {}).get("namespace", "")
        try:
            resp = self._client.create(serde.resource_path(kind, namespace), wire)
        except ApiError as e:
            raise _api_error_to_store(e) from e
        resp.setdefault("kind", kind)
        stored = serde.from_wire(resp)
        self._apply_upsert(stored)
        return copy.deepcopy(stored)
