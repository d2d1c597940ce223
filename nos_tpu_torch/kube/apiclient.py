"""A Kubernetes API client over the standard library: counterpart of
``nos_tpu/kube/apiclient.py`` (``:33-329``).

Credential loading (a kubeconfig, JSON or YAML: explicit path,
``$KUBECONFIG``, ``~/.kube/config``; or a pod's service account), the verbs (get, create,
replace, merge patch, delete, list) with API errors as ``ApiError``, and
streamed watches (``?watch=true``, newline-delimited JSON events over a
chunked response) on ``http.client``, with TLS (a CA, a client
certificate) when the credentials carry it. ``Backoff`` is the
reflectors' capped exponential backoff, with seeded jitter so a failure
sequence always gives the same delays. Connections are kept a thread.
"""
from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import random
import ssl
import tempfile
import threading
import urllib.parse
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from nos_tpu_torch.util.documents import load_document

logger = logging.getLogger("nos_tpu_torch.kube.apiclient")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class Backoff:
    """Capped exponential backoff with deterministic, seeded jitter.

    client-go's ``wait.Backoff`` analogue for watch reconnects: every
    failure doubles the delay up to ``cap``; ``reset()`` — called after a
    successful re-list — drops back to ``base``. Jitter spreads a thundering
    herd of reflectors reconnecting after one apiserver hiccup, but is drawn
    from a private ``random.Random(seed)`` so a given (seed, failure
    sequence) always produces the same delays — the chaos harness depends on
    fault timing being a pure function of its seed.
    """

    def __init__(
        self,
        base: float = 0.2,
        cap: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
    ) -> None:
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._failures = 0

    @property
    def failures(self) -> int:
        """Consecutive failures since the last reset."""
        return self._failures

    def next(self) -> float:
        delay = min(self.cap, self.base * (self.factor ** self._failures))
        self._failures += 1
        return delay * (1.0 + self.jitter * self._rng.random())

    def reset(self) -> None:
        self._failures = 0


class ApiError(Exception):
    def __init__(self, status: int, reason: str, body: str = ""):
        super().__init__(f"apiserver returned {status} {reason}: {body[:200]}")
        self.status = status
        self.reason = reason
        self.body = body


@dataclass
class ClusterCredentials:
    """Everything needed to open an authenticated connection."""

    server: str  # e.g. https://10.0.0.1:6443 or http://127.0.0.1:18080
    token: str = ""
    ca_data: Optional[bytes] = None  # PEM
    client_cert_data: Optional[bytes] = None  # PEM
    client_key_data: Optional[bytes] = None  # PEM
    insecure_skip_tls_verify: bool = False

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if self.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_data:
            ctx.load_verify_locations(cadata=self.ca_data.decode())
        if self.client_cert_data and self.client_key_data:
            # ssl only loads cert chains from files: stage the PEMs in a
            # private tempdir for the duration of the load.
            with tempfile.TemporaryDirectory(prefix="nos-tpu-torch-tls-") as d:
                cert = os.path.join(d, "cert.pem")
                key = os.path.join(d, "key.pem")
                with open(cert, "wb") as f:
                    f.write(self.client_cert_data)
                with open(key, "wb") as f:
                    f.write(self.client_key_data)
                ctx.load_cert_chain(cert, key)
        return ctx


def _b64_or_file(entry: Dict[str, Any], data_key: str, file_key: str) -> Optional[bytes]:
    if entry.get(data_key):
        return base64.b64decode(entry[data_key])
    if entry.get(file_key):
        with open(entry[file_key], "rb") as f:
            return f.read()
    return None


def load_kubeconfig(
    path: Optional[str] = None, context: Optional[str] = None
) -> ClusterCredentials:
    """Parse a kubeconfig (mirrors client-go clientcmd's order: explicit
    path, $KUBECONFIG, ~/.kube/config), JSON-first: PyYAML is imported
    only for a document that is not JSON."""
    path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
    cfg = load_document(path) or {}

    ctx_name = context or cfg.get("current-context")
    contexts = {c["name"]: c["context"] for c in cfg.get("contexts") or []}
    if ctx_name not in contexts:
        raise ValueError(f"kubeconfig {path}: context {ctx_name!r} not found")
    ctx = contexts[ctx_name]
    clusters = {c["name"]: c["cluster"] for c in cfg.get("clusters") or []}
    users = {u["name"]: u["user"] for u in cfg.get("users") or []}
    cluster = clusters.get(ctx.get("cluster"), {})
    user = users.get(ctx.get("user"), {})

    token = user.get("token", "")
    if not token and user.get("tokenFile"):
        with open(user["tokenFile"]) as f:
            token = f.read().strip()

    return ClusterCredentials(
        server=cluster.get("server", ""),
        token=token,
        ca_data=_b64_or_file(cluster, "certificate-authority-data", "certificate-authority"),
        client_cert_data=_b64_or_file(user, "client-certificate-data", "client-certificate"),
        client_key_data=_b64_or_file(user, "client-key-data", "client-key"),
        insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
    )


def load_in_cluster() -> ClusterCredentials:
    """Service-account credentials mounted into every pod (what client-go's
    rest.InClusterConfig reads)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise RuntimeError("not running in a cluster (KUBERNETES_SERVICE_HOST unset)")
    with open(os.path.join(SERVICE_ACCOUNT_DIR, "token")) as f:
        token = f.read().strip()
    with open(os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"), "rb") as f:
        ca = f.read()
    return ClusterCredentials(server=f"https://{host}:{port}", token=token, ca_data=ca)


class KubeApiClient:
    """Thin REST client: verbs + watch streaming, per-thread connections."""

    def __init__(self, creds: ClusterCredentials, timeout: float = 30.0):
        self.creds = creds
        self.timeout = timeout
        u = urllib.parse.urlparse(creds.server)
        self._https = u.scheme == "https"
        self._host = u.hostname or "localhost"
        self._port = u.port or (443 if self._https else 80)
        self._ssl = creds.ssl_context()
        self._local = threading.local()

    @classmethod
    def from_kubeconfig(
        cls, path: Optional[str] = None, context: Optional[str] = None
    ) -> "KubeApiClient":
        return cls(load_kubeconfig(path, context))

    @classmethod
    def in_cluster(cls) -> "KubeApiClient":
        return cls(load_in_cluster())

    # ------------------------------------------------------------- plumbing

    def _connect(self, timeout: Optional[float] = None) -> http.client.HTTPConnection:
        if self._https:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout or self.timeout, context=self._ssl
            )
        return http.client.HTTPConnection(
            self._host, self._port, timeout=timeout or self.timeout
        )

    def _headers(self, content_type: str = "application/json") -> Dict[str, str]:
        h = {"Accept": "application/json", "Content-Type": content_type}
        if self.creds.token:
            h["Authorization"] = f"Bearer {self.creds.token}"
        return h

    def request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, str]] = None,
        content_type: str = "application/json",
    ) -> Dict[str, Any]:
        if params:
            path = f"{path}?{urllib.parse.urlencode(params)}"
        conn = getattr(self._local, "conn", None)
        # bytes: http.client sends the headers and a bytes body in one
        # segment (a str body goes apart, into Nagle's wait for the
        # peer's delayed ACK, some 40 ms a request)
        payload = json.dumps(body).encode() if body is not None else None
        for attempt in (0, 1):  # one retry on a stale kept-alive connection
            if conn is None:
                conn = self._connect()
                self._local.conn = conn
            sent = False
            try:
                conn.request(method, path, body=payload, headers=self._headers(content_type))
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, ConnectionError, OSError):
                conn.close()
                self._local.conn = conn = None
                # Writes are only retried when the request never reached the
                # wire (send-phase failure on a stale kept-alive socket); a
                # response-phase failure may mean the server already
                # committed a POST/PUT/DELETE — surfacing beats repeating.
                if attempt or (sent and method != "GET"):
                    raise
        if resp.status >= 400:
            raise ApiError(resp.status, resp.reason or "", data.decode(errors="replace"))
        return json.loads(data) if data else {}

    # ----------------------------------------------------------------- CRUD

    def get(self, path: str, params: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        return self.request("GET", path, params=params)

    def create(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self.request("POST", path, body=obj)

    def replace(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self.request("PUT", path, body=obj)

    def merge_patch(self, path: str, patch: Dict[str, Any]) -> Dict[str, Any]:
        return self.request(
            "PATCH", path, body=patch, content_type="application/merge-patch+json"
        )

    def delete(self, path: str) -> Dict[str, Any]:
        return self.request("DELETE", path)

    def list(
        self, path: str, params: Optional[Dict[str, str]] = None
    ) -> Tuple[List[Dict[str, Any]], str]:
        """List → (items, resourceVersion) for watch continuation."""
        out = self.get(path, params)
        rv = str((out.get("metadata") or {}).get("resourceVersion", ""))
        return list(out.get("items") or []), rv

    # ---------------------------------------------------------------- watch

    def watch(
        self,
        path: str,
        resource_version: str = "",
        stop: Optional[threading.Event] = None,
        timeout_seconds: int = 300,
    ) -> Iterator[Dict[str, Any]]:
        """Stream watch events ({"type": ..., "object": {...}}) until the
        server closes the window, an error occurs, or `stop` is set.

        The caller loops (re-watching from the last seen resourceVersion)
        exactly like a client-go reflector; a 410 Gone surfaces as ApiError
        telling the caller to relist."""
        params = {
            "watch": "true",
            "timeoutSeconds": str(timeout_seconds),
            "allowWatchBookmarks": "true",
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        qs = urllib.parse.urlencode(params)
        conn = self._connect(timeout=timeout_seconds + 15)
        try:
            conn.request("GET", f"{path}?{qs}", headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                raise ApiError(
                    resp.status, resp.reason or "", resp.read().decode(errors="replace")
                )
            buf = b""
            while not (stop and stop.is_set()):
                chunk = resp.read1(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    if event.get("type") == "ERROR":
                        status = event.get("object") or {}
                        raise ApiError(
                            int(status.get("code", 500)),
                            status.get("reason", "watch error"),
                            status.get("message", ""),
                        )
                    yield event
        finally:
            conn.close()
