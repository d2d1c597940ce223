"""The runner every component process shares.

Counterpart of ``nos_tpu/cmd/_component.py:25-195``: each reference
binary takes one ``--config <file>`` (SURVEY.md §2.1), and so does each
component here: parse the flags, read the config (JSON, or YAML where
PyYAML is installed), build the store and the component onto a
``Manager``, serve ``/healthz``, ``/readyz`` and ``/metrics``, run until
SIGINT or SIGTERM (or an injected ``stop_event``: signal handlers work
only on the main thread, so in-process callers pass one).

The config's blocks:

- ``store``: ``type: in-memory`` (the default), ``kubeconfig``
  (``kubeconfig: <path>``, ``context: <name>``) or ``in-cluster`` (the
  pod's service account), the last two a ``KubeApiStore`` synced before
  the build (``syncTimeoutSeconds``, 30), ``kinds`` to narrow its kinds.
- ``manager``: ``healthProbePort`` (8081; ``--health-port`` wins),
  ``healthProbeHost`` (``0.0.0.0``: the kubelet probes the pod's IP),
  ``metricsAuthTokenFile`` (a bearer token re-read on each scrape; a
  missing file answers 401) and ``metricsLoopbackPort`` (``/metrics`` on
  its own 127.0.0.1 listener).
- ``leaderElection``: ``enabled``, ``identity`` (host-pid), ``namespace``
  (``nos-system``), ``leaseDurationSeconds`` (15), ``renewPeriodSeconds``
  (5). When enabled the manager starts on the lease and a lost lease
  stops the process, the controller-runtime contract. On the way out the
  manager stops before the lease is released (the reference releases
  first), so a successor never reconciles beside a leader that is still
  stopping.

Every component runs the observability plane: a health timeline
sampling every ``manager.timelineSampleSeconds`` (5; above 0), whose
findings become ``HealthDegraded`` events about the
``default/nos-health-timeline`` ConfigMap, and the stack profiler, on
from the health server's start to the way out. It serves
``/debug/traces``, ``/debug/vars``, ``/debug/profile``,
``/debug/timeline`` and ``/debug/loops``; a component whose build
returns an object with ``explain`` (the scheduler) serves it as
``/debug/explain``, one with ``debug_payload`` (the autoscaler) as
``/debug/autoscaler``.
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import threading
from typing import Any, Callable, Optional

from nos_tpu_torch.kube.controller import Manager
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.util.documents import load_document
from nos_tpu_torch.util.health import HealthServer, token_file_provider
from nos_tpu_torch.util.loop_health import LOOPS
from nos_tpu_torch.util.profiling import PROFILER

log = logging.getLogger("nos_tpu_torch.cmd")

DEFAULT_HEALTH_PORT = 8081


def load_config(path: str) -> dict:
    """The component config at ``path`` ({} for none)."""
    if not path:
        return {}
    return load_document(path) or {}


def build_store(config: dict) -> NodeStore:
    """The store the config's ``store`` block names."""
    store_cfg = config.get("store") or {}
    kind = store_cfg.get("type", "in-memory")
    if kind == "in-memory":
        return NodeStore()
    from nos_tpu_torch.kube.apiclient import KubeApiClient
    from nos_tpu_torch.kube.apistore import KubeApiStore

    if kind == "kubeconfig":
        client = KubeApiClient.from_kubeconfig(store_cfg.get("kubeconfig") or None,
                                               store_cfg.get("context") or None)
    elif kind == "in-cluster":
        client = KubeApiClient.in_cluster()
    else:
        raise ValueError(f"unknown store type {kind!r}")
    kinds = store_cfg.get("kinds")
    store = KubeApiStore(client, kinds=kinds) if kinds else KubeApiStore(client)
    store.start(sync_timeout_s=float(store_cfg.get("syncTimeoutSeconds", 30)))
    return store


def component_argparser(name: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=f"python -m nos_tpu_torch {name}",
                                     description=f"the nos {name} component")
    parser.add_argument("--config", default="", help="the component config (JSON or YAML)")
    parser.add_argument("--health-port", type=int, default=None)
    parser.add_argument("-v", "--verbose", action="count", default=0)
    return parser


def build_timeline(config: dict, store: NodeStore, component: str, flight=None):
    """The health timeline of the config's ``manager`` block, its
    findings recorded as events through ``store`` and, given ``flight``
    (a ``FlightRecorder``), as ``timeline.finding`` records."""
    from nos_tpu_torch.api.config.v1alpha1 import timeline_sample_seconds
    from nos_tpu_torch.kube.events import EventRecorder
    from nos_tpu_torch.kube.objects import ConfigMap
    from nos_tpu_torch.timeline import TimelineStore

    timeline = TimelineStore(
        interval_seconds=timeline_sample_seconds(config.get("manager") or {}))
    timeline.attach(flight=flight, recorder=EventRecorder(store, component=component),
                    event_obj=ConfigMap("nos-health-timeline", "default"))
    return timeline


def health_server(config: dict, port: Optional[int], component: Any, store: NodeStore,
                  timeline=None, record_fn=None) -> HealthServer:
    """The component's health server, from the config's ``manager`` block."""
    manager_cfg = config.get("manager") or {}
    if port is None:
        port = int(manager_cfg.get("healthProbePort", DEFAULT_HEALTH_PORT))
    token_file = manager_cfg.get("metricsAuthTokenFile", "")
    loopback = manager_cfg.get("metricsLoopbackPort")
    return HealthServer(
        port=port, host=manager_cfg.get("healthProbeHost", "0.0.0.0"),
        metrics_token=token_file_provider(token_file) if token_file else "",
        metrics_loopback_port=int(loopback) if loopback is not None else None,
        explain_fn=getattr(component, "explain", None), profiler=PROFILER,
        loops_fn=lambda: LOOPS.payload(store=store),
        autoscaler_fn=getattr(component, "debug_payload", None),
        timeline_fn=timeline.debug_payload if timeline is not None else None,
        timeline_stream_fn=timeline.iter_jsonl if timeline is not None else None,
        record_fn=record_fn)


def run_component(name: str, build: Callable[[Manager, dict], Any], argv=None,
                  stop_event: Optional[threading.Event] = None,
                  on_started: Optional[Callable[[dict], None]] = None) -> int:
    """Build the component with ``build(manager, config)`` and serve it
    until stopped; 0. ``on_started`` gets {"health_port", "manager",
    "component", "elector", "timeline"} once it serves (in-process
    callers)."""
    args = component_argparser(name).parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # the handlers first: a signal that arrives once /healthz answers
    # must stop the process cleanly, never kill it
    stop = stop_event or threading.Event()
    if stop_event is None:
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    config = load_config(args.config)
    store = build_store(config)
    manager = Manager(store)
    health = elector = timeline = None
    # the manager starts on the lease unless the process already stops
    leading, stopped = threading.Lock(), [False]

    def lead() -> None:
        with leading:
            if not stopped[0]:
                manager.start()

    try:
        component = build(manager, config)
        timeline = build_timeline(config, store, f"nos-{name}-health-timeline")
        health = health_server(config, args.health_port, component, store, timeline)
        port = health.start()
        log.info("%s: health and metrics on port %d", name, port)
        PROFILER.start()
        timeline.start()
        le_cfg = config.get("leaderElection") or {}
        if le_cfg.get("enabled", False):
            from nos_tpu_torch.kube.leaderelection import LeaderElector

            identity = le_cfg.get("identity") or f"{socket.gethostname()}-{os.getpid()}"
            elector = LeaderElector(
                store, name=f"nos-tpu-{name}", identity=identity,
                namespace=le_cfg.get("namespace", "nos-system"),
                lease_duration_s=float(le_cfg.get("leaseDurationSeconds", 15)),
                renew_period_s=float(le_cfg.get("renewPeriodSeconds", 5)),
                on_started_leading=lead, on_stopped_leading=stop.set)
            elector.start()
            log.info("%s: waiting for the lease as %s", name, identity)
        else:
            manager.start()
        log.info("%s running", name)
        if on_started is not None:
            on_started({"health_port": port, "manager": manager, "component": component,
                        "elector": elector, "timeline": timeline})
        stop.wait()
    finally:
        # the controllers stop while the lease is still held, and only then
        # is it released: the next leader never runs beside this one
        with leading:
            stopped[0] = True
            manager.stop()
        if elector is not None:
            elector.stop()
        if timeline is not None:
            timeline.stop()
            timeline.close()
        PROFILER.stop()
        if health is not None:
            health.stop()
        if hasattr(store, "stop"):
            store.stop()
    log.info("%s stopped", name)
    return 0
