"""An in-process Kubernetes API server for the API-backed store:
counterpart of ``nos_tpu/sim/apiserver.py`` (``StubApiServer``,
``:53-485``).

A real HTTP server (``ThreadingHTTPServer`` on 127.0.0.1, a free port)
serving the subset of the API the suite speaks, as Kubernetes JSON under
the reference's routes: create, get, replace, merge patch (the main
resource, or ``/status``) and delete with resource versions and
optimistic-concurrency conflicts (409), the pod ``binding`` subresource
(``spec.nodeName`` is immutable through a patch), namespaced and
all-namespace lists, and streamed watches from a resource version,
with an idle BOOKMARK every half second. ``compact(revision)`` drops the
event log up to a revision, after which a watch from an older version
gets 410 Gone, as an API server answers once etcd has compacted it.
``inject`` and ``read`` let a test write and read wire objects as an
outside client. The reference's chaos fault gate waits for item 18b.3.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

_PREFIXES = ("/api/v1", "/apis/policy/v1", "/apis/nos.nebuly.com/v1alpha1")

_PLURAL_TO_KIND = {
    "pods": "Pod",
    "nodes": "Node",
    "configmaps": "ConfigMap",
    "services": "Service",
    "events": "Event",
    "poddisruptionbudgets": "PodDisruptionBudget",
    "elasticquotas": "ElasticQuota",
    "compositeelasticquotas": "CompositeElasticQuota",
}


class _State:
    def __init__(self) -> None:
        self.lock = threading.Condition()
        self.rv = 0
        self.uid = 0
        # (plural, ns, name) -> wire object
        self.objects: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        # append-only event log: (rv, type, plural, wire object)
        self.events: List[Tuple[int, str, str, Dict[str, Any]]] = []
        # the log holds no event at or below this version
        self.compacted = 0

    def bump(self) -> int:
        self.rv += 1
        return self.rv

    def record(self, etype: str, plural: str, obj: Dict[str, Any]) -> None:
        self.events.append((int(obj["metadata"]["resourceVersion"]), etype, plural, obj))
        self.lock.notify_all()


class StubApiServer:
    """`with StubApiServer() as s: KubeApiClient(creds(s.url))`."""

    def __init__(self, disabled_plurals=()) -> None:
        self.state = _State()
        state = self.state
        disabled = set(disabled_plurals)  # simulate uninstalled CRDs (404)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a reply's headers and body are two writes: without
            # TCP_NODELAY the second waits on the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet
                pass

            # -------------------------------------------------- plumbing
            def _send_json(self, code: int, payload: Dict[str, Any]) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, reason: str, message: str = "") -> None:
                self._send_json(
                    code,
                    {
                        "kind": "Status",
                        "status": "Failure",
                        "code": code,
                        "reason": reason,
                        "message": message or reason,
                    },
                )

            def _route(self):
                """path -> (plural, namespace, name, subresource, query)."""
                path, _, query = self.path.partition("?")
                params = {}
                if query:
                    for part in query.split("&"):
                        k, _, v = part.partition("=")
                        params[k] = v
                for prefix in _PREFIXES:
                    if path.startswith(prefix + "/"):
                        rest = [p for p in path[len(prefix):].split("/") if p]
                        if not rest:
                            return None
                        if rest[0] == "namespaces" and len(rest) >= 3:
                            ns, plural = rest[1], rest[2]
                            name = rest[3] if len(rest) > 3 else ""
                            sub = rest[4] if len(rest) > 4 else ""
                        else:
                            plural = rest[0]
                            ns = ""
                            name = rest[1] if len(rest) > 1 else ""
                            sub = rest[2] if len(rest) > 2 else ""
                        if plural in _PLURAL_TO_KIND and plural not in disabled:
                            return plural, ns, name, sub, params
                return None

            def _read_body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n)) if n else {}

            def _drain_body(self) -> None:
                """Consume an unread request body before replying early.

                Responding without reading the body leaves its bytes in the
                keep-alive stream; the NEXT request on the connection then
                parses as body-garbage + request-line ("Bad request
                syntax"), poisoning an innocent caller. Every reply path
                that fires before _read_body() must drain first."""
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    try:
                        self.rfile.read(n)
                    except (OSError, ValueError):
                        self.close_connection = True

            # ------------------------------------------------------ verbs
            def do_GET(self) -> None:
                route = self._route()
                if not route:
                    return self._error(404, "NotFound", self.path)
                plural, ns, name, sub, params = route
                if name:
                    with state.lock:
                        obj = state.objects.get((plural, ns, name))
                    if obj is None:
                        return self._error(404, "NotFound", f"{plural} {ns}/{name}")
                    return self._send_json(200, obj)
                if params.get("watch") == "true":
                    return self._watch(plural, ns, params)
                with state.lock:
                    items = [
                        o
                        for (p, o_ns, _), o in sorted(state.objects.items())
                        if p == plural and (not ns or o_ns == ns)
                    ]
                    rv = state.rv
                return self._send_json(
                    200,
                    {
                        "kind": _PLURAL_TO_KIND[plural] + "List",
                        "metadata": {"resourceVersion": str(rv)},
                        "items": items,
                    },
                )

            def do_POST(self) -> None:
                route = self._route()
                if not route:
                    self._drain_body()
                    return self._error(404, "NotFound", self.path)
                plural, ns, name, sub, _ = route
                if sub == "binding":
                    return self._bind(plural, ns, name)
                obj = self._read_body()
                meta = obj.setdefault("metadata", {})
                if ns:
                    meta["namespace"] = ns
                name = meta.get("name", "")
                key = (plural, meta.get("namespace", ""), name)
                with state.lock:
                    if key in state.objects:
                        return self._error(
                            409, "AlreadyExists", f"{plural} {name} already exists"
                        )
                    state.uid += 1
                    meta.setdefault("uid", f"stub-uid-{state.uid}")
                    meta.setdefault(
                        "creationTimestamp",
                        time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                    )
                    meta["resourceVersion"] = str(state.bump())
                    state.objects[key] = obj
                    state.record("ADDED", plural, obj)
                self._send_json(201, obj)

            def do_PUT(self) -> None:
                route = self._route()
                if not route or not route[2]:
                    self._drain_body()
                    return self._error(404, "NotFound", self.path)
                plural, ns, name, _, _ = route
                obj = self._read_body()
                meta = obj.setdefault("metadata", {})
                key = (plural, meta.get("namespace", ns), name)
                with state.lock:
                    current = state.objects.get(key)
                    if current is None:
                        return self._error(404, "NotFound", f"{plural} {ns}/{name}")
                    sent_rv = str(meta.get("resourceVersion") or "")
                    cur_rv = str(current["metadata"]["resourceVersion"])
                    if sent_rv and sent_rv != cur_rv:
                        return self._error(
                            409,
                            "Conflict",
                            f"operation cannot be fulfilled: object modified "
                            f"(have {sent_rv}, want {cur_rv})",
                        )
                    meta["uid"] = current["metadata"].get("uid", "")
                    meta.setdefault(
                        "creationTimestamp", current["metadata"].get("creationTimestamp")
                    )
                    meta["resourceVersion"] = str(state.bump())
                    state.objects[key] = obj
                    state.record("MODIFIED", plural, obj)
                self._send_json(200, obj)

            def _bind(self, plural: str, ns: str, name: str) -> None:
                """POST …/pods/{name}/binding — the real bind verb."""
                body = self._read_body()
                target = (body.get("target") or {}).get("name", "")
                if plural != "pods" or not target:
                    return self._error(400, "BadRequest", "invalid binding")
                with state.lock:
                    obj = state.objects.get((plural, ns, name))
                    if obj is None:
                        return self._error(404, "NotFound", f"{plural} {ns}/{name}")
                    if (obj.get("spec") or {}).get("nodeName"):
                        return self._error(
                            409, "Conflict", "pod is already assigned to a node"
                        )
                    obj.setdefault("spec", {})["nodeName"] = target
                    obj["metadata"]["resourceVersion"] = str(state.bump())
                    state.record("MODIFIED", plural, obj)
                self._send_json(201, {"kind": "Status", "status": "Success"})

            def _merge_apply(self, target: Dict[str, Any], patch: Dict[str, Any]) -> None:
                for k, v in patch.items():
                    if v is None:
                        target.pop(k, None)
                    elif isinstance(v, dict) and isinstance(target.get(k), dict):
                        self._merge_apply(target[k], v)
                    else:
                        target[k] = v

            def do_PATCH(self) -> None:
                route = self._route()
                if not route or not route[2]:
                    self._drain_body()
                    return self._error(404, "NotFound", self.path)
                plural, ns, name, sub, _ = route
                if "merge-patch" not in (self.headers.get("Content-Type") or ""):
                    self._drain_body()
                    return self._error(415, "UnsupportedMediaType")
                patch = self._read_body()
                with state.lock:
                    obj = state.objects.get((plural, ns, name))
                    if obj is None:
                        return self._error(404, "NotFound", f"{plural} {ns}/{name}")
                    sent_rv = str(((patch.get("metadata") or {}).get("resourceVersion")) or "")
                    cur_rv = str(obj["metadata"]["resourceVersion"])
                    if sent_rv and sent_rv != cur_rv:
                        return self._error(
                            409, "Conflict",
                            f"object modified (have {sent_rv}, want {cur_rv})",
                        )
                    if sub == "status":
                        # subresource: only the status stanza applies
                        self._merge_apply(
                            obj.setdefault("status", {}), patch.get("status") or {}
                        )
                    elif sub:
                        return self._error(404, "NotFound", f"subresource {sub}")
                    else:
                        # main resource: status + immutable fields rejected,
                        # like a real apiserver
                        if "status" in patch and plural != "configmaps":
                            return self._error(
                                422, "Invalid",
                                "status must be updated via the /status subresource",
                            )
                        if (patch.get("spec") or {}).get("nodeName") and plural == "pods":
                            return self._error(
                                422, "Invalid", "spec.nodeName: field is immutable (use binding)"
                            )
                        patch = dict(patch)
                        patch.get("metadata", {}).pop("resourceVersion", None)
                        self._merge_apply(obj, patch)
                    obj["metadata"]["resourceVersion"] = str(state.bump())
                    state.record("MODIFIED", plural, obj)
                self._send_json(200, obj)

            def do_DELETE(self) -> None:
                route = self._route()
                if not route or not route[2]:
                    return self._error(404, "NotFound", self.path)
                plural, ns, name, _, _ = route
                with state.lock:
                    obj = state.objects.pop((plural, ns, name), None)
                    if obj is None:
                        return self._error(404, "NotFound", f"{plural} {ns}/{name}")
                    obj = dict(obj)
                    obj["metadata"] = dict(obj["metadata"])
                    obj["metadata"]["resourceVersion"] = str(state.bump())
                    state.record("DELETED", plural, obj)
                self._send_json(200, obj)

            # ------------------------------------------------------ watch
            def _watch(self, plural: str, ns: str, params: Dict[str, str]) -> None:
                since = int(params.get("resourceVersion") or 0)
                with state.lock:
                    gone = since and since < state.compacted
                if gone:
                    return self._error(410, "Expired",
                                       f"too old resource version: {since} "
                                       f"({state.compacted})")
                deadline = time.monotonic() + float(params.get("timeoutSeconds") or 60)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send_chunk(payload: Dict[str, Any]) -> bool:
                    data = (json.dumps(payload) + "\n").encode()
                    try:
                        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()
                        return True
                    except (OSError, ValueError):
                        # Any socket failure — broken pipe, reset, closed
                        # file object — means the client is gone: end this
                        # watch quietly instead of letting the exception
                        # propagate out of the handler thread.
                        return False

                cursor = since
                last_write = time.monotonic()
                try:
                    while time.monotonic() < deadline:
                        with state.lock:
                            pending = [
                                (rv, et, o)
                                for (rv, et, p, o) in state.events
                                if rv > cursor
                                and p == plural
                                and (not ns or o["metadata"].get("namespace", "") == ns)
                            ]
                            rv_now = state.rv
                            if not pending:
                                state.lock.wait(timeout=0.2)
                        if not pending:
                            # Idle heartbeat: a BOOKMARK keeps the client's
                            # resourceVersion fresh AND probes the socket, so
                            # a disconnected watcher is reaped within ~a
                            # second instead of parking its handler thread
                            # (and re-scanning the event log) until the full
                            # timeoutSeconds deadline.
                            if time.monotonic() - last_write >= 0.5:
                                bookmark = {
                                    "type": "BOOKMARK",
                                    "object": {
                                        "metadata": {"resourceVersion": str(rv_now)}
                                    },
                                }
                                if not send_chunk(bookmark):
                                    return
                                last_write = time.monotonic()
                            continue
                        for rv, etype, obj in pending:
                            cursor = max(cursor, rv)
                            if not send_chunk({"type": etype, "object": obj}):
                                return
                            last_write = time.monotonic()
                    try:  # terminating zero-chunk
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except (OSError, ValueError):
                        pass
                except (OSError, ValueError):
                    # Disconnect surfaced outside send_chunk (e.g. while
                    # flushing headers): same story — die quietly.
                    pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="stub-apiserver", daemon=True
        )

    # ------------------------------------------------------------ lifecycle
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "StubApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def compact(self, revision: Optional[int] = None) -> None:
        """Drop the event log up to ``revision`` (the current one by
        default): a watch from an older version then gets 410 Gone."""
        with self.state.lock:
            upto = self.state.rv if revision is None else revision
            self.state.events = [e for e in self.state.events if e[0] > upto]
            self.state.compacted = max(self.state.compacted, upto)

    def __enter__(self) -> "StubApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # Test convenience: inject/read wire objects directly (an "external
    # client" the store under test doesn't know about).
    def inject(self, plural: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        meta = obj.setdefault("metadata", {})
        key = (plural, meta.get("namespace", ""), meta.get("name", ""))
        with self.state.lock:
            created = key not in self.state.objects
            self.state.uid += 1
            meta.setdefault("uid", f"stub-uid-{self.state.uid}")
            meta["resourceVersion"] = str(self.state.bump())
            self.state.objects[key] = obj
            self.state.record("ADDED" if created else "MODIFIED", plural, obj)
        return obj

    def read(self, plural: str, ns: str, name: str) -> Optional[Dict[str, Any]]:
        with self.state.lock:
            obj = self.state.objects.get((plural, ns, name))
            return json.loads(json.dumps(obj)) if obj else None
