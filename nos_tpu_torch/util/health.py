"""The health, readiness and metrics endpoints of a component.

Counterpart of ``nos_tpu/util/health.py:25-541``: every reference binary
serves ``/healthz`` and ``/readyz`` probes and a metrics endpoint on its
manager (cmd/operator/operator.go:112-118). ``/readyz`` asks
``ready_check``; ``/metrics`` renders the port's ``util/metrics.py``
registry.

The debug endpoints live in one registry (``_debug_endpoints``): the
bearer gate and the ``/debug/`` index derive from it, so an endpoint is
never served ungated or unlisted, and one whose backend is not wired is
not registered. Always: ``/debug/traces`` (the trace store's summaries,
newest first, with its ``retention`` accounting; ``?id=<trace_id>`` one
trace as Chrome trace events; ``?limit=`` / ``?cursor=`` page, and
``?format=jsonl`` streams one summary a line) and ``/debug/vars`` (the
registry's snapshot as flat JSON). Wired by the caller:
``/debug/explain?pod=<ns>/<name>`` (the scheduler's latest diagnosis of
the pod), ``/debug/profile`` (the profiler's document;
``?format=collapsed`` the collapsed stacks, ``?action=start|stop``
switches sampling), ``/debug/loops`` (``util/loop_health.py``'s
``LOOPS.payload``), ``/debug/slo`` (an ``SLOEngine``'s
``debug_payload``), ``/debug/autoscaler`` (the ModelServing reconciler's
rollup) and ``/debug/timeline`` (the health timeline's rollups,
sparklines, watchdog loops and findings; ``?window=<seconds>``,
``?limit=`` / ``?cursor=`` page the series, ``?format=jsonl`` streams the
ring's frames) and ``/debug/record`` (the flight recorder's ring as JSON,
``?format=jsonl`` one record a line, ``python -m nos_tpu_torch replay``'s
input; not registered, so 404, while recording is off). The reference's
capacity and forecast endpoints wait for their backends (ROADMAP.md,
item 18b.3). A page holds
``debug_page_limit`` items unless ``?limit=`` says otherwise.

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

from nos_tpu_torch.obsplane.streaming import jsonl_lines, page_params
from nos_tpu_torch.util.metrics import REGISTRY
from nos_tpu_torch.util.tracing import TRACER

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
                 profiler: Optional[Any] = None,
                 loops_fn: Optional[Callable[[], dict]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 autoscaler_fn: Optional[Callable[[], dict]] = None,
                 timeline_fn: Optional[Callable[..., dict]] = None,
                 timeline_stream_fn: Optional[Callable[[], Any]] = None,
                 record_fn: Optional[Callable[[], list]] = None,
                 debug_page_limit: int = 500) -> None:
        self.port = port
        self.ready_check = ready_check or (lambda: True)
        self.host = host
        self.metrics_token = metrics_token
        self.metrics_loopback_port = metrics_loopback_port
        self.explain_fn = explain_fn
        self.profiler = profiler
        self.loops_fn = loops_fn
        self.slo_fn = slo_fn
        self.autoscaler_fn = autoscaler_fn
        # called with the ?window= seconds (None: the whole ring) and the page
        self.timeline_fn = timeline_fn
        self.timeline_stream_fn = timeline_stream_fn
        # the flight recorder's ring (None: recording is off)
        self.record_fn = record_fn
        self.debug_page_limit = debug_page_limit
        self._servers: list = []
        self._threads: list = []

    # ----------------------------------------------------- debug registry

    def _debug_endpoints(self) -> Dict[str, Dict[str, Any]]:
        """path → {"describe", "handle"} of every wired debug endpoint (the
        descriptions are the reference's)."""
        endpoints: Dict[str, Dict[str, Any]] = {}

        def register(path: str, describe: str, handle: Callable[[Any, Any], None]) -> None:
            endpoints[path] = {"describe": describe, "handle": handle}

        register("/debug/traces",
                 "per-trace summaries newest-first with retention accounting; "
                 "?id=<trace_id> for the full Chrome trace-event timeline; "
                 "?limit=/?cursor= paginate, ?format=jsonl streams one summary per line",
                 self._serve_traces)
        register("/debug/vars", "the MetricsRegistry snapshot as flat JSON",
                 lambda req, url: req.respond_json(REGISTRY.snapshot()))
        if self.explain_fn is not None:
            register("/debug/explain",
                     "?pod=<namespace>/<name> — the scheduler's latest per-node "
                     "per-plugin rejection Diagnosis for the pod",
                     self._serve_explain)
        if self.record_fn is not None:
            register("/debug/record",
                     "the flight recorder's decision ring; ?format=jsonl for "
                     "`python -m nos_tpu_torch replay` input",
                     self._serve_record)
        if self.profiler is not None:
            register("/debug/profile",
                     "the control-plane sampling profiler: JSON top-N self-time "
                     "and phase attribution; ?format=collapsed for flamegraph "
                     "input; ?action=start|stop for runtime control",
                     self._serve_profile)
        if self.loops_fn is not None:
            register("/debug/loops",
                     "loop-health rollup: per-loop busy fractions, watch queue "
                     "depths, drain lag and phase-duration metric families",
                     lambda req, url: req.respond_json(self.loops_fn()))
        if self.slo_fn is not None:
            register("/debug/slo",
                     "serving SLO rollup: per-SLO fast/slow-window burn rates, "
                     "compliance, error-budget remaining, recent violations "
                     "linked into /debug/traces",
                     lambda req, url: req.respond_json(self.slo_fn()))
        if self.autoscaler_fn is not None:
            register("/debug/autoscaler",
                     "model autoscaler rollup: per-ModelServing desired/ready "
                     "replicas, last verdict, cold starts, and the burn/queue "
                     "signal registry",
                     lambda req, url: req.respond_json(self.autoscaler_fn()))
        if self.timeline_fn is not None:
            register("/debug/timeline",
                     "the longitudinal health timeline: windowed per-series "
                     "rollups and sparkline arrays over the sampled ring, the "
                     "wedge-watchdog loop registry, and leak/stall/regression "
                     "detector findings; ?window=<seconds> bounds the rollup "
                     "window, ?limit=/?cursor= paginate the per-series tables, "
                     "?format=jsonl streams the delta-encoded ring frames",
                     self._serve_timeline)
        return endpoints

    def _page_params(self, req, url) -> Optional[dict]:
        """The page's keyword arguments; a 400 and None on a bad limit."""
        query = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            return page_params(query, default_limit=self.debug_page_limit)
        except ValueError:
            req.respond(400, "limit must be a non-negative integer")
            return None

    def _serve_traces(self, req, url) -> None:
        wanted = parse_qs(url.query).get("id", [None])[0]
        if wanted:
            trace = TRACER.store.get(wanted)
            if trace is None:
                req.respond(404, "unknown trace id")
            else:
                req.respond_json(trace.to_chrome())
            return
        page = self._page_params(req, url)
        if page is None:
            return
        summaries, next_cursor = TRACER.store.summaries_page(limit=page["limit"],
                                                             cursor=page["cursor"])
        if page["jsonl"]:
            req.respond_stream(jsonl_lines(summaries))
            return
        req.respond_json({"traces": summaries, "retention": TRACER.store.retention_stats(),
                          "page": {"limit": page["limit"], "next_cursor": next_cursor}})

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

    def _serve_record(self, req, url) -> None:
        records = self.record_fn()
        if parse_qs(url.query).get("format", ["json"])[0] == "jsonl":
            req.respond(200, "".join(json.dumps(r) + "\n" for r in records),
                        "application/x-ndjson")
        else:
            req.respond(200, json.dumps(records, indent=2), "application/json")

    def _serve_profile(self, req, url) -> None:
        query = parse_qs(url.query)
        action = query.get("action", [None])[0]
        if action == "start":
            req.respond_json({"enabled": True, "started": self.profiler.start()})
        elif action == "stop":
            req.respond_json({"enabled": False, "stopped": self.profiler.stop()})
        elif action is not None:
            req.respond(400, "action must be start or stop")
        elif query.get("format", ["json"])[0] == "collapsed":
            req.respond(200, self.profiler.collapsed())
        else:
            req.respond_json(self.profiler.debug_payload())

    def _serve_timeline(self, req, url) -> None:
        page = self._page_params(req, url)
        if page is None:
            return
        if page["jsonl"] and self.timeline_stream_fn is not None:
            req.respond_stream(jsonl_lines(self.timeline_stream_fn()))
            return
        raw = parse_qs(url.query).get("window", [None])[0]
        window: Optional[float] = None
        if raw is not None:
            try:
                window = float(raw)
            except ValueError:
                req.respond(400, "window must be a number of seconds")
                return
        req.respond_json(self.timeline_fn(window, limit=page["limit"], cursor=page["cursor"]))

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

            def respond_stream(self, chunks, ctype: str = "application/x-ndjson") -> None:
                """Chunked transfer encoding over an iterable of bytes: the
                response is written as it is produced."""
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in chunks:
                        if chunk:
                            self.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

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
