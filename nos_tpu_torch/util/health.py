"""The health, readiness and metrics endpoints of a component.

Counterpart of ``nos_tpu/util/health.py:25-541``: every reference binary
serves ``/healthz`` and ``/readyz`` probes and a metrics endpoint on its
manager (cmd/operator/operator.go:112-118). ``/readyz`` asks
``ready_check``; ``/metrics`` renders the port's ``util/metrics.py``
registry.

The debug endpoints live in one registry (``_debug_endpoints``): the
bearer gate and the ``/debug/`` index derive from it, so an endpoint is
never served ungated or unlisted, and one whose backend is not wired is
not registered. Wired here: ``/debug/explain?pod=<ns>/<name>`` (the
scheduler's latest diagnosis of the pod), ``/debug/loops``
(``util/loop_health.py``'s ``LOOPS.payload``) and ``/debug/autoscaler``
(the ModelServing reconciler's rollup). The reference's traces, vars,
record, capacity, profile, forecast, timeline and slo endpoints have
their backends in item 18b and stay unregistered (``ROADMAP.md``).

``metrics_token``, a string or a provider called on each request: when
set, ``/metrics`` and every debug endpoint need ``Authorization: Bearer
<token>``, and a provider that returns None (its file is missing) fails
closed with 401. The probes stay open. ``metrics_loopback_port`` moves
``/metrics`` and the debug endpoints to a listener of their own on
127.0.0.1, for a proxy in front of it, while the probes keep
``(host, port)``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Union
from urllib.parse import parse_qs, urlsplit

from nos_tpu_torch.util.metrics import REGISTRY

TokenSource = Union[str, Callable[[], Optional[str]]]


def token_file_provider(path: str) -> Callable[[], Optional[str]]:
    """A bearer token read from ``path`` on every request (a rotated
    secret takes effect without a restart); None when the file cannot be
    read, which the gate answers with 401."""
    def read() -> Optional[str]:
        try:
            with open(path) as fh:
                return fh.read().strip()
        except OSError:
            return None

    return read


class HealthServer:
    def __init__(self, port: int = 8081, ready_check: Optional[Callable[[], bool]] = None,
                 host: str = "127.0.0.1", metrics_token: TokenSource = "",
                 metrics_loopback_port: Optional[int] = None,
                 explain_fn: Optional[Callable[[str], Optional[dict]]] = None,
                 loops_fn: Optional[Callable[[], dict]] = None,
                 autoscaler_fn: Optional[Callable[[], dict]] = None) -> None:
        self.port = port
        self.ready_check = ready_check or (lambda: True)
        self.host = host
        self.metrics_token = metrics_token
        self.metrics_loopback_port = metrics_loopback_port
        self.explain_fn = explain_fn
        self.loops_fn = loops_fn
        self.autoscaler_fn = autoscaler_fn
        self._servers: list = []
        self._threads: list = []

    # ----------------------------------------------------- debug registry

    def _debug_endpoints(self) -> Dict[str, Dict[str, Any]]:
        """path → {"describe", "handle"} of every wired debug endpoint."""
        endpoints: Dict[str, Dict[str, Any]] = {}
        if self.explain_fn is not None:
            endpoints["/debug/explain"] = {
                "describe": "?pod=<namespace>/<name>: the scheduler's latest per-node "
                            "per-plugin rejection diagnosis of the pod",
                "handle": self._serve_explain}
        if self.loops_fn is not None:
            endpoints["/debug/loops"] = {
                "describe": "loop health: each loop's busy fraction, queue depths and "
                            "watch drain lag",
                "handle": lambda req, url: req.respond_json(self.loops_fn())}
        if self.autoscaler_fn is not None:
            endpoints["/debug/autoscaler"] = {
                "describe": "the model autoscaler: each ModelServing's desired and ready "
                            "replicas, last verdict and the signal registry",
                "handle": lambda req, url: req.respond_json(self.autoscaler_fn())}
        return endpoints

    def _serve_explain(self, req, url) -> None:
        pod_key = parse_qs(url.query).get("pod", [None])[0]
        if not pod_key:
            req.respond(400, "missing ?pod=namespace/name")
            return
        diagnosis = self.explain_fn(pod_key)
        if diagnosis is None:
            req.respond(404, "no diagnosis recorded for pod")
            return
        req.respond_json(diagnosis)

    # ------------------------------------------------------------ serving

    def _make_handler(self, serve_health: bool, serve_metrics: bool):
        ready_check = self.ready_check
        token_source = self.metrics_token
        endpoints = self._debug_endpoints()
        index = {path: entry["describe"] for path, entry in endpoints.items()}

        def authorized(header: str) -> bool:
            if not token_source:
                return True
            token = token_source() if callable(token_source) else token_source
            # a missing or empty token fails closed
            return bool(token) and header == f"Bearer {token}"

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a quiet keep-alive connection must not pin a thread past stop()
            timeout = 5.0

            def do_GET(self) -> None:  # noqa: N802 (http.server's name)
                url = urlsplit(self.path)
                path = url.path
                if path == "/healthz" and serve_health:
                    self.respond(200, "ok")
                elif path == "/readyz" and serve_health:
                    if ready_check():
                        self.respond(200, "ok")
                    else:
                        self.respond(503, "not ready")
                elif serve_metrics and (path in ("/metrics", "/debug", "/debug/")
                                        or path in endpoints):
                    if not authorized(self.headers.get("Authorization", "")):
                        self.respond(401, "unauthorized")
                    elif path == "/metrics":
                        self.respond(200, REGISTRY.render(), "text/plain; version=0.0.4")
                    elif path in endpoints:
                        endpoints[path]["handle"](self, url)
                    else:
                        self.respond_json({"endpoints": index})
                else:
                    self.respond(404, "not found")

            def respond(self, code: int, body: str, ctype: str = "text/plain") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def respond_json(self, payload: Any) -> None:
                self.respond(200, json.dumps(payload, indent=2, sort_keys=True, default=str),
                             "application/json")

            def log_message(self, *args) -> None:
                pass

        return Handler

    def start(self) -> int:
        """Serve; the bound probe port (port 0 takes a free one)."""
        split = self.metrics_loopback_port is not None
        main = ThreadingHTTPServer((self.host, self.port),
                                   self._make_handler(serve_health=True, serve_metrics=not split))
        main.daemon_threads = True
        self._servers = [main]
        if split:
            side = ThreadingHTTPServer(("127.0.0.1", self.metrics_loopback_port),
                                       self._make_handler(serve_health=False,
                                                          serve_metrics=True))
            side.daemon_threads = True
            self._servers.append(side)
        self._threads = []
        for i, server in enumerate(self._servers):
            # a short poll: shutdown() waits for it on the way out
            thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1},
                                      name=f"health-{i}", daemon=True)
            thread.start()
            self._threads.append(thread)
        return main.server_address[1]

    def stop(self) -> None:
        for server in self._servers:
            server.shutdown()
            server.server_close()
        for thread in self._threads:
            thread.join(timeout=2.0)
