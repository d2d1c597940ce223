"""The component processes, run in process through ``run_component``.

- Each component (``operator``, ``partitioner``, ``scheduler``,
  ``autoscaler``, ``migagent`` on the sim devices, ``mpsagent``) serves
  ``/healthz`` and ``/readyz``, its controllers' loop families on
  ``/metrics``, and stops within 10 s of its stop event, returning 0.
- The bearer gate: a token file that is missing answers 401, the token
  opens ``/metrics`` and ``/debug/``; the probes stay open; with
  ``metricsLoopbackPort`` ``/metrics`` moves to its own listener;
  ``/readyz`` answers the ready check, and ``/debug/`` lists only the
  endpoints whose backend is wired.
- ``/debug/explain`` returns the scheduler's latest diagnosis of a pod.
- Each component runs the observability plane: ``/debug/timeline``
  serves its health timeline (the watchdog's loops, the controllers'
  workers among them), ``/debug/profile`` the running stack profiler;
  both stop with the component, and a non-positive
  ``timelineSampleSeconds`` is refused.
- The MIG agent refuses to start without NVML, and without ``NODE_NAME``.
- Leader election hands the scheduler over between two components on
  one API server: the second binds once the first stops. A component
  stops its manager before it releases the lease.
- ``partitioner-capacity-freed`` fires the batch of the mode whose
  resources the freed pod held, a deleted pod's included.
- One subprocess: ``python -m nos_tpu_torch scheduler`` serves
  ``/healthz`` (within 60 s: the package imports torch) and exits 0 on
  SIGTERM (within 60 s).
"""
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, RESOURCE_GPU
from nos_tpu_torch.kube.store import Node, Pod

ROOT = Path(__file__).resolve().parents[1]


def _get(port, path, token=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Running:
    """A component's ``main`` on a thread, stopped on exit."""

    def __init__(self, command, config, tmp_path, name="config.json"):
        path = tmp_path / name
        path.write_text(json.dumps(config))
        self.stop = threading.Event()
        self.started = threading.Event()
        self.info = {}
        module = importlib.import_module(f"nos_tpu_torch.cmd.{command}")

        def run():
            self.info["rc"] = module.main(
                ["--config", str(path), "--health-port", "0"], stop_event=self.stop,
                on_started=lambda info: (self.info.update(info), self.started.set()))

        self.thread = threading.Thread(target=run, daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.started.wait(30), self.info
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(10)

    @property
    def port(self):
        return self.info["health_port"]


LOCAL = {"manager": {"healthProbeHost": "127.0.0.1"}}
COMPONENTS = [("operator", ["elasticquota", "compositeelasticquota"]),
              ("partitioner", ["partitioner-mig", "partitioner-mps", "state-node-mig",
                               "partitioner-divergence", "multinode-expander"]),
              ("scheduler", ["scheduler", "reservation-janitor"]),
              ("autoscaler", ["autoscaler"]),
              ("migagent", ["migagent-reporter-node-a", "migagent-actuator-node-a"]),
              ("mpsagent", ["mpsagent-reporter-node-a"])]


@pytest.mark.parametrize("command,loops", COMPONENTS, ids=[c[0] for c in COMPONENTS])
def test_each_component_serves_health_and_stops(command, loops, tmp_path, monkeypatch):
    monkeypatch.setenv("NODE_NAME", "node-a")
    with Running(command, LOCAL, tmp_path) as c:
        assert _get(c.port, "/healthz") == (200, "ok")
        assert _get(c.port, "/readyz") == (200, "ok")
        status, body = _get(c.port, "/metrics")
        assert status == 200
        for loop in loops:
            assert f'nos_tpu_controller_busy_fraction{{loop="{loop}"}}' in body, loop
        status, body = _get(c.port, "/debug/loops")
        assert status == 200 and set(loops) <= set(json.loads(body)["loops"])
        t0 = time.monotonic()
    assert not c.thread.is_alive() and time.monotonic() - t0 < 10.0
    assert c.info["rc"] == 0


def test_the_token_gate_fails_closed(tmp_path):
    token_file = tmp_path / "token"
    config = {"manager": {"healthProbeHost": "127.0.0.1",
                          "metricsAuthTokenFile": str(token_file)}}
    with Running("scheduler", config, tmp_path) as c:
        assert _get(c.port, "/metrics")[0] == 401  # no file: closed
        assert _get(c.port, "/metrics", token="anything")[0] == 401
        assert _get(c.port, "/healthz") == (200, "ok")
        token_file.write_text("s3cret\n")  # re-read on every scrape
        assert _get(c.port, "/metrics")[0] == 401
        assert _get(c.port, "/metrics", token="wrong")[0] == 401
        assert _get(c.port, "/metrics", token="s3cret")[0] == 200
        assert _get(c.port, "/debug/")[0] == 401
        status, body = _get(c.port, "/debug/", token="s3cret")
        assert status == 200 and "/debug/explain" in json.loads(body)["endpoints"]
        token_file.unlink()
        assert _get(c.port, "/metrics", token="s3cret")[0] == 401


def test_readyz_answers_the_ready_check():
    from nos_tpu_torch.util.health import HealthServer

    ready = threading.Event()
    server = HealthServer(port=0, ready_check=ready.is_set)
    port = server.start()
    try:
        assert _get(port, "/readyz") == (503, "not ready")
        assert _get(port, "/healthz") == (200, "ok")
        ready.set()
        assert _get(port, "/readyz") == (200, "ok")
        # nothing wired: the two endpoints whose backends every process has
        status, body = _get(port, "/debug/")
        assert status == 200
        assert sorted(json.loads(body)["endpoints"]) == ["/debug/traces", "/debug/vars"]
    finally:
        server.stop()


def test_metrics_move_to_the_loopback_listener(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        loopback = s.getsockname()[1]
    config = {"manager": {"healthProbeHost": "127.0.0.1", "metricsLoopbackPort": loopback}}
    with Running("operator", config, tmp_path) as c:
        assert _get(c.port, "/healthz") == (200, "ok")
        assert _get(c.port, "/metrics")[0] == 404
        assert _get(loopback, "/metrics")[0] == 200
        assert _get(loopback, "/healthz")[0] == 404


def test_debug_explain_returns_the_latest_diagnosis(tmp_path):
    with Running("scheduler", LOCAL, tmp_path) as c:
        store = c.info["manager"].store
        store.create(Node("mig-0", labels={PARTITIONING_LABEL: "mig"},
                          capacity={RESOURCE_GPU: 8}, allocatable={RESOURCE_GPU: 8}))
        store.create(Pod("stuck", "team-a", request={"nvidia.com/mig-3g.40gb": 1},
                         scheduler_name="nos-scheduler"))
        deadline = time.monotonic() + 20
        while _get(c.port, "/debug/explain?pod=team-a/stuck")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        diagnosis = json.loads(_get(c.port, "/debug/explain?pod=team-a/stuck")[1])
        assert diagnosis["pod"] == "team-a/stuck"
        assert diagnosis["message"].startswith("0/1 nodes are available: 1 insufficient "
                                               "nvidia.com/mig-3g.40gb")
        assert diagnosis["nodes"]["mig-0"]["plugin"] == "NodeResourcesFit"
        assert _get(c.port, "/debug/explain?pod=team-a/other")[0] == 404
        assert _get(c.port, "/debug/explain")[0] == 400


def test_a_component_serves_its_timeline_and_profile(tmp_path):
    from nos_tpu_torch.timeline.watchdog import WATCHDOG
    from nos_tpu_torch.util.profiling import PROFILER

    with Running("scheduler", LOCAL, tmp_path) as c:
        timeline = c.info["timeline"]
        assert timeline.interval_seconds == 5.0
        timeline.sample_once()  # driven here, not counted off the sampler's thread
        status, body = _get(c.port, "/debug/timeline?window=600")
        assert status == 200
        doc = json.loads(body)
        loops = {loop["name"]: loop["periodic"] for loop in doc["watchdog"]["loops"]}
        assert loops["timeline-sampler"] is True and loops["scheduler-work"] is False
        assert "loop.scheduler-work" in doc["rollups"] and doc["samples"] >= 1
        status, body = _get(c.port, "/debug/profile")
        profile = json.loads(body)
        assert status == 200 and profile["enabled"]
        assert {"scheduler-pump", "scheduler-work"} <= set(profile["threads"])
        status, body = _get(c.port, "/debug/")
        assert {"/debug/timeline", "/debug/profile", "/debug/traces", "/debug/vars",
                "/debug/explain", "/debug/loops"} <= set(json.loads(body)["endpoints"])
        assert _get(c.port, "/debug/timeline?format=jsonl")[1].startswith(
            '{"base": ')
    assert c.info["rc"] == 0
    assert not PROFILER.enabled and timeline._cursor is None
    assert "timeline-sampler" not in WATCHDOG.periodic_loops()


def test_a_non_positive_timeline_interval_is_refused(tmp_path):
    from nos_tpu_torch.api.config import ConfigError
    from nos_tpu_torch.cmd import operator

    path = tmp_path / "config.json"
    path.write_text(json.dumps({"manager": {"healthProbeHost": "127.0.0.1",
                                            "timelineSampleSeconds": 0}}))
    with pytest.raises(ConfigError, match="timelineSampleSeconds"):
        operator.main(["--config", str(path), "--health-port", "0"],
                      stop_event=threading.Event())


def test_the_mig_agent_refuses_without_nvml_or_a_node(tmp_path, monkeypatch, capsys):
    from nos_tpu_torch.cmd import migagent

    config = tmp_path / "nvml.json"
    config.write_text(json.dumps({"deviceBackend": "nvml", **LOCAL}))
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert migagent.main(["--config", str(config)]) == 1
    assert "NODE_NAME" in capsys.readouterr().err
    monkeypatch.setenv("NODE_NAME", "node-a")
    # no NVML here (on the card: MIG mode off): refused before it serves
    assert migagent.main(["--config", str(config), "--health-port", "0"],
                         stop_event=threading.Event()) == 1
    assert capsys.readouterr().err.startswith("migagent: ")


def _kubeconfig(tmp_path, server):
    doc = {"apiVersion": "v1", "kind": "Config", "current-context": "stub",
           "clusters": [{"name": "stub", "cluster": {"server": server.url}}],
           "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
           "users": [{"name": "stub", "user": {}}]}
    path = tmp_path / "kubeconfig.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _wait(predicate, timeout):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_leader_election_hands_the_scheduler_over(tmp_path):
    from nos_tpu_torch.kube.apiclient import ClusterCredentials, KubeApiClient
    from nos_tpu_torch.kube.apistore import KubeApiStore
    from nos_tpu_torch.sim.apiserver import StubApiServer

    kinds = ["Node", "Pod", "ConfigMap"]
    with StubApiServer() as server:
        def config(identity):
            return {"store": {"type": "kubeconfig", "kubeconfig": _kubeconfig(tmp_path, server),
                              "kinds": kinds},
                    "scheduler": {"retrySeconds": 0.2},
                    "leaderElection": {"enabled": True, "identity": identity,
                                       "leaseDurationSeconds": 1.0, "renewPeriodSeconds": 0.1},
                    **LOCAL}

        writer = KubeApiStore(KubeApiClient(ClusterCredentials(server=server.url)), kinds=kinds)
        writer.start()
        try:
            writer.create(Node("mig-0", labels={PARTITIONING_LABEL: "mig"},
                               capacity={RESOURCE_GPU: 8},
                               allocatable={RESOURCE_GPU: 8, "nvidia.com/mig-1g.10gb": 4}))
            with Running("scheduler", config("a"), tmp_path, "a.json") as a, \
                    Running("scheduler", config("b"), tmp_path, "b.json") as b:
                first, second = (a, b) if _wait(lambda: a.info["elector"].is_leader, 10) \
                    else (b, a)
                assert first.info["elector"].is_leader and not second.info["elector"].is_leader
                writer.create(Pod("one", request={"nvidia.com/mig-1g.10gb": 1},
                                  scheduler_name="nos-scheduler"))
                assert _wait(lambda: writer.get("Pod", "one", "default").node == "mig-0", 10)
                first.stop.set()
                first.thread.join(10)
                assert first.info["rc"] == 0
                t0 = time.monotonic()
                writer.create(Pod("two", request={"nvidia.com/mig-1g.10gb": 1},
                                  scheduler_name="nos-scheduler"))
                assert _wait(lambda: writer.get("Pod", "two", "default").node == "mig-0", 1.0 + 5)
                assert second.info["elector"].is_leader
                assert time.monotonic() - t0 < 6.0
        finally:
            writer.stop()


def test_the_manager_stops_before_the_lease_is_released(tmp_path, monkeypatch):
    from nos_tpu_torch.kube.leaderelection import LeaderElector

    seen = []
    release = LeaderElector.release

    def recording_release(elector):
        manager = c.info["manager"]
        seen.append([ctl._stop.is_set() for ctl in manager.controllers])
        release(elector)

    monkeypatch.setattr(LeaderElector, "release", recording_release)
    config = {"leaderElection": {"enabled": True, "identity": "a",
                                 "leaseDurationSeconds": 1.0, "renewPeriodSeconds": 0.1},
              **LOCAL}
    with Running("scheduler", config, tmp_path) as c:
        assert _wait(lambda: any(t.is_alive() for ctl in c.info["manager"].controllers
                                 for t in ctl._threads), 10)
    assert c.info["rc"] == 0
    assert len(seen) == 1 and seen[0] and all(seen[0])
    store = c.info["manager"].store
    lease = store.get("ConfigMap", "nos-tpu-scheduler", "nos-system")
    assert lease.annotations["nos.nebuly.com/leader-holder"] == ""


def test_capacity_freed_fires_the_mode_the_pod_held():
    from nos_tpu_torch.cmd.partitioner import build_partitioner
    from nos_tpu_torch.kube.controller import Manager
    from nos_tpu_torch.kube.store import NodeStore, PodPhase

    store = NodeStore()
    manager = Manager(store)
    mig = build_partitioner(manager)
    mps = mig.mps
    for name, kind in (("mig-0", "mig"), ("mps-0", "mps")):
        store.create(Node(name, labels={PARTITIONING_LABEL: kind}, capacity={RESOURCE_GPU: 8},
                          allocatable={RESOURCE_GPU: 8}))
    # a pending pod of each mode that a new plan could help
    for name, resource in (("wait-mig", "nvidia.com/mig-3g.40gb"),
                           ("wait-mps", "nvidia.com/gpu-20gb")):
        store.create(Pod(name, request={resource: 1}, unschedulable=True,
                         scheduler_name=mig.scheduler_name))
    store.create(Pod("done-mig", node="mig-0", phase=PodPhase.RUNNING,
                     request={"nvidia.com/mig-1g.10gb": 1}))
    store.create(Pod("gone-mps", node="mps-0", phase=PodPhase.RUNNING,
                     request={"nvidia.com/gpu-10gb": 1}))
    store.create(Pod("gone-plain", node="mig-0", phase=PodPhase.RUNNING,
                     request={RESOURCE_GPU: 1}))

    def drain():
        manager.drain(["partitioner-capacity-freed"])
        return mig.capacity_freed_fires, mps.capacity_freed_fires

    try:
        assert drain() == (0, 0)  # nothing finished yet
        store.patch_merge("Pod", "done-mig", "default",
                          lambda p: setattr(p, "phase", PodPhase.SUCCEEDED))
        assert drain() == (1, 0)
        store.delete("Pod", "gone-mps", "default")
        assert drain() == (1, 1)
        store.delete("Pod", "gone-plain", "default")  # neither mode's resources
        assert drain() == (1, 1)
    finally:
        mig.close()
        mps.close()


def test_the_scheduler_process_serves_and_exits_on_sigterm(tmp_path):
    config = tmp_path / "scheduler.json"
    config.write_text(json.dumps(LOCAL))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-m", "nos_tpu_torch", "scheduler", "--config",
                             str(config), "--health-port", str(port)], cwd=tmp_path, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        def healthy():
            try:
                return _get(port, "/healthz") == (200, "ok")
            except OSError:
                return proc.poll() is not None
        assert _wait(healthy, 60.0) and proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
