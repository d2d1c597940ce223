"""The observability plane's debug endpoints and configuration
(nos_tpu_torch.util.health, obsplane/, api/config, cmd/run.py) against
the reference's.

- ``/debug/``: for the same wiring (nothing; every backend the port has)
  the index equals the reference ``HealthServer``'s registry, path for
  path and description for description. Every endpoint answers 401
  without the bearer token and with a wrong one.
- ``/debug/traces``: a summary page with ``retention``, ``?id=`` as Chrome
  trace events (404 for an unknown id), the paging cursor, ``?format=jsonl``
  over chunked encoding, a 400 on a bad limit; ``/debug/vars`` the
  registry's snapshot; ``/debug/profile`` its document,
  ``?format=collapsed`` and ``?action=start|stop`` (400 for another);
  ``/debug/slo`` an ``SLOEngine``'s ``debug_payload``; ``/debug/timeline``
  with ``?window=`` (400 when not a number) and ``?limit=``.
- ``obsplane/streaming``: ``paginate``, ``page_params`` and
  ``jsonl_lines`` equal the reference's on the same inputs;
  ``governor``'s budgets and report equal on the same registries;
  ``apply_observability`` applies and reverts on a fresh registry and
  tracer.
- ``ObservabilityConfig`` and ``observability_from``: the same sections
  decode to the same fields, the same bad values raise ``ConfigError``,
  and ``nodeTopK`` above 0 is refused, naming item 18b.3.
- ``python -m nos_tpu_torch run`` applies the section while it runs and
  puts the process's budgets and retention back on the way out.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import pytest

from nos_tpu.api.config import v1alpha1 as jcfg
from nos_tpu.cmd import run as jrun
from nos_tpu.obsplane import governor as jgov
from nos_tpu.obsplane import streaming as jstream
from nos_tpu.util import metrics as jmetrics
from nos_tpu.util.health import HealthServer as RefHealthServer
from nos_tpu_torch.api.config import v1alpha1 as tcfg
from nos_tpu_torch.cmd import run as trun
from nos_tpu_torch.obsplane import governor as tgov
from nos_tpu_torch.obsplane import streaming as tstream
from nos_tpu_torch.obsplane.apply import apply_observability
from nos_tpu_torch.slo.engine import SLOEngine
from nos_tpu_torch.timeline.sizes import SizeRegistry
from nos_tpu_torch.timeline.store import TimelineStore
from nos_tpu_torch.timeline.watchdog import WedgeWatchdog
from nos_tpu_torch.util import metrics as tmetrics
from nos_tpu_torch.util import tracing as ttracing
from nos_tpu_torch.util.health import HealthServer
from nos_tpu_torch.util.profiling import StackProfiler

TOKEN = "s3cret"


def _get(port, path, token=TOKEN):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def _wiring():
    """Every backend the port has, and the same callables for the
    reference's server (never started)."""
    timeline = TimelineStore(clock=lambda: 1000.0, vitals=False, metrics_fn=lambda: {"x": 1.0},
                             sizes=SizeRegistry(), watchdog=WedgeWatchdog())
    timeline.sample_once()
    return dict(explain_fn=lambda key: {"pod": key} if key == "ns/p" else None,
                profiler=StackProfiler(), loops_fn=lambda: {"loops": {}},
                slo_fn=SLOEngine(["p95 ttft < 400ms"]).debug_payload,
                autoscaler_fn=lambda: {"servings": {}},
                timeline_fn=timeline.debug_payload), timeline


def _index(server):
    return {path: entry["describe"] for path, entry in server._debug_endpoints().items()}


def test_the_index_equals_the_references_for_the_same_wiring():
    assert _index(HealthServer(port=0)) == _index(RefHealthServer(port=0))
    wiring, _ = _wiring()
    ours = _index(HealthServer(port=0, **wiring))
    assert ours == _index(RefHealthServer(port=0, **wiring))
    assert sorted(ours) == ["/debug/autoscaler", "/debug/explain", "/debug/loops",
                            "/debug/profile", "/debug/slo", "/debug/timeline",
                            "/debug/traces", "/debug/vars"]


@pytest.fixture(scope="module")
def served():
    """A gated server on every backend; ``/debug/traces`` reads a fresh
    tracer holding five traces."""
    from nos_tpu_torch.util import health

    wiring, timeline = _wiring()
    tracer = ttracing.Tracer()
    for i in range(5):
        with tracer.span("debug.test", i=i):
            pass
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(health, "TRACER", tracer)
        server = HealthServer(port=0, metrics_token=TOKEN,
                              timeline_stream_fn=timeline.iter_jsonl, debug_page_limit=3,
                              **wiring)
        port = server.start()
        yield port, wiring, timeline
        server.stop()


ENDPOINTS = ["/debug/", "/debug", "/debug/traces", "/debug/vars", "/debug/explain?pod=ns/p",
             "/debug/profile", "/debug/loops", "/debug/slo", "/debug/autoscaler",
             "/debug/timeline", "/metrics"]


@pytest.mark.parametrize("path", ENDPOINTS)
def test_every_endpoint_is_gated(served, path):
    port = served[0]
    assert _get(port, path, token=None)[0] == 401
    assert _get(port, path, token="wrong")[0] == 401
    assert _get(port, path)[0] == 200
    assert _get(port, "/healthz", token=None)[0] == 200


def test_debug_traces_pages_and_streams(served):
    port = served[0]
    status, body, _ = _get(port, "/debug/traces")
    doc = json.loads(body)
    assert status == 200 and set(doc) == {"traces", "retention", "page"}
    assert doc["page"]["limit"] == 3 and len(doc["traces"]) == 3  # the server's page size
    assert [t["root"] for t in doc["traces"]] == ["debug.test"] * 3
    assert doc["traces"][0]["attributes"] == {"i": 4}
    cursor = doc["page"]["next_cursor"]
    status, body, _ = _get(port, f"/debug/traces?limit=2&cursor={cursor}")
    page2 = json.loads(body)
    assert [t["attributes"]["i"] for t in page2["traces"]] == [1, 0]
    assert page2["traces"][0]["seq"] < doc["traces"][-1]["seq"]
    tid = doc["traces"][0]["trace_id"]
    status, body, _ = _get(port, f"/debug/traces?id={tid}")
    chrome = json.loads(body)
    assert chrome["otherData"]["trace_id"] == tid and chrome["traceEvents"][0]["ph"] == "X"
    assert _get(port, "/debug/traces?id=nope")[0] == 404
    status, body, headers = _get(port, "/debug/traces?format=jsonl&limit=4")
    assert headers["Transfer-Encoding"] == "chunked"
    lines = [json.loads(x) for x in body.splitlines()]
    assert len(lines) == 4 and lines[0]["trace_id"] == tid
    assert _get(port, "/debug/traces?limit=-1")[0] == 400
    assert _get(port, "/debug/traces?limit=x")[0] == 400


def test_debug_vars_profile_slo_and_timeline(served):
    port, wiring, timeline = served
    status, body, _ = _get(port, "/debug/vars")
    assert status == 200 and isinstance(json.loads(body), dict)
    profiler = wiring["profiler"]
    with profiler.registered("debug-test"):
        profiler.sample_once()
    doc = json.loads(_get(port, "/debug/profile")[1])
    assert doc["threads"] == [] and doc["total_samples"] == 1 and not doc["enabled"]
    assert _get(port, "/debug/profile?format=collapsed")[1].startswith("debug-test;(no-phase);")
    assert json.loads(_get(port, "/debug/profile?action=start")[1]) == {
        "enabled": True, "started": True}
    assert json.loads(_get(port, "/debug/profile?action=start")[1])["started"] is False
    assert json.loads(_get(port, "/debug/profile?action=stop")[1]) == {
        "enabled": False, "stopped": True}
    assert _get(port, "/debug/profile?action=pause")[0] == 400
    slo = json.loads(_get(port, "/debug/slo")[1])
    want = json.loads(json.dumps(wiring["slo_fn"]()))
    assert {k: v for k, v in slo.items() if k != "now"} == \
        {k: v for k, v in want.items() if k != "now"}
    doc = json.loads(_get(port, "/debug/timeline?window=60&limit=1")[1])
    assert doc["samples"] == 1 and doc["window_seconds"] == 60.0
    assert doc["page"]["limit"] == 1 and doc["page"]["total_series"] == len(timeline.names())
    assert _get(port, "/debug/timeline?window=soon")[0] == 400
    frames = _get(port, "/debug/timeline?format=jsonl")[1].splitlines()
    assert json.loads(frames[0])["kind"] == "timeline.base" and len(frames) == 2
    assert json.loads(_get(port, "/debug/explain?pod=ns/p")[1]) == {"pod": "ns/p"}
    assert _get(port, "/debug/explain?pod=ns/q")[0] == 404


PAGING = [([], 0, ""), (["a", "b", "c", "d"], 0, ""), (["a", "b", "c", "d"], 2, ""),
          (["a", "b", "c", "d"], 2, "b"), (["a", "b", "c", "d"], 3, "c"),
          (["node-00001", "node-00002", "node-00010"], 1, "node-00001"),
          (["a", "b"], 5, "zz"), (["a", "b", "c"], -1, "a")]


@pytest.mark.parametrize("keys,limit,cursor", PAGING)
def test_paging_equals_the_references(keys, limit, cursor):
    assert tstream.paginate(keys, limit, cursor) == jstream.paginate(keys, limit, cursor)


@pytest.mark.parametrize("query", [{}, {"limit": "5"}, {"pool": "p", "cursor": "c",
                                                        "format": "jsonl"},
                                   {"limit": "-2"}, {"limit": "x"}, {"format": "json"}])
def test_page_params_equal_the_references(query):
    def call(mod):
        try:
            return mod.page_params(query, default_limit=7)
        except ValueError as e:
            return ("ValueError", str(e).split(":")[0])

    assert call(tstream) == call(jstream)


def test_jsonl_lines_equal_the_references():
    records = [{"b": 1, "a": [1, 2]}, {"z": None}]
    assert list(tstream.jsonl_lines(records)) == list(jstream.jsonl_lines(records))


def test_the_governor_report_equals_the_references():
    reports = []
    for mod, gov, cfg in ((jmetrics, jgov, jcfg), (tmetrics, tgov, tcfg)):
        obs = cfg.ObservabilityConfig(series_budget={"fam_a": 2}, series_budget_default=3)
        budgets, default = gov.budgets_from(obs)
        reg = mod.MetricsRegistry()
        reg.apply_series_budgets(budgets, default=default)
        for i in range(5):
            reg.gauge("fam_a", "a").labels(node=str(i)).set(i)
            reg.counter("fam_b", "b").labels(node=str(i)).inc()
        reports.append((budgets, default, gov.governor_report(reg), reg.render()))
    assert reports[1] == reports[0]
    assert reports[1][2]["over_budget"] == ["fam_a", "fam_b"]
    assert tgov.budgets_from(tcfg.ObservabilityConfig(series_budget_default=0)) == ({}, None)


def test_apply_observability_applies_and_reverts():
    reg, tracer = tmetrics.MetricsRegistry(), ttracing.Tracer()
    reg.gauge("fam_a", "a")
    obs = tcfg.ObservabilityConfig(series_budget={"fam_a": 1}, series_budget_default=5,
                                   trace_tail_capacity=2, trace_boring_sample_n=3,
                                   trace_slow_thresholds={"pod.journey": 1.0})
    revert = apply_observability(obs, registry=reg, tracer=tracer)
    assert reg.series_report()["fam_a"]["budget"] == 1
    assert reg.counter("later_total")._budget == 5
    policy = tracer.store._retention
    assert (policy.tail_capacity, policy.boring_sample_n, policy.slow_thresholds) == (
        2, 3, {"pod.journey": 1.0})
    revert()
    assert reg.series_report().get("fam_a") is None  # no children, no budget
    assert reg.counter("newer_total")._budget is None
    assert tracer.store._retention == ttracing.RetentionPolicy()


SECTIONS = [
    {},
    {"observability": {}},
    {"observability": {"seriesBudget": {"default": 512, "nos_tpu_capacity_node_chips": 3000},
                       "traceTailCapacity": 128, "traceBoringSampleN": 4,
                       "traceSlowThresholds": {"pod.journey": 2.0}, "debugPageLimit": 50}},
    {"observability": {"seriesBudgetDefault": 9, "debugPageLimit": 0}},
    {"observability": {"seriesBudget": {"fam": 0}}},
    {"observability": {"seriesBudget": {"default": -1}}},
    {"observability": {"traceTailCapacity": -1}},
    {"observability": {"traceBoringSampleN": 0}},
    {"observability": {"traceSlowThresholds": {"pod.journey": 0}}},
    {"observability": {"debugPageLimit": -5}},
    {"observability": {"nodeTopK": -1}},
]


@pytest.mark.parametrize("config", SECTIONS, ids=[str(i) for i in range(len(SECTIONS))])
def test_the_section_decodes_and_validates_as_the_references(config):
    def decode(cfg_mod, run_mod):
        try:
            obs = run_mod.observability_from(config)
            obs.validate()
            return dataclasses.asdict(obs)
        except cfg_mod.ConfigError as e:
            return ("ConfigError", str(e))

    assert decode(tcfg, trun) == decode(jcfg, jrun)


def test_node_top_k_is_refused_naming_its_item():
    jrun.observability_from({"observability": {"nodeTopK": 50}}).validate()
    with pytest.raises(tcfg.ConfigError, match="item 18b.3"):
        trun.observability_from({"observability": {"nodeTopK": 50}})


def test_the_timeline_interval_must_be_positive():
    assert tcfg.timeline_sample_seconds({}) == 5.0
    assert tcfg.timeline_sample_seconds({"timelineSampleSeconds": 0.2}) == 0.2
    with pytest.raises(tcfg.ConfigError, match="timelineSampleSeconds"):
        tcfg.timeline_sample_seconds({"timelineSampleSeconds": 0})


def test_the_suite_applies_the_section_while_it_runs(tmp_path):
    config = {"manager": {"healthProbeHost": "127.0.0.1", "timelineSampleSeconds": 0.05},
              "observability": {"seriesBudget": {"default": 100000},
                                "traceTailCapacity": 7, "debugPageLimit": 4}}
    path = tmp_path / "suite.json"
    path.write_text(json.dumps(config))
    stop, started, seen = threading.Event(), threading.Event(), {}
    prev_policy = ttracing.TRACER.store._retention

    def on_started(info):
        seen["budget"] = tmetrics.REGISTRY._default_budget
        seen["tail"] = ttracing.TRACER.store._retention.tail_capacity
        status, body, _ = _get(info["health_port"], "/debug/timeline", token=None)
        seen["timeline"] = (status, json.loads(body)["page"]["limit"])
        seen["index"] = sorted(json.loads(_get(info["health_port"], "/debug/", None)[1])
                               ["endpoints"])
        started.set()
        stop.set()

    rc = trun.main(["--config", str(path), "--health-port", "0"], stop_event=stop,
                   on_started=on_started)
    assert rc == 0 and started.is_set()
    assert seen["budget"] == 100000 and seen["tail"] == 7
    assert seen["timeline"] == (200, 4)
    assert {"/debug/timeline", "/debug/profile", "/debug/traces", "/debug/vars"} <= set(
        seen["index"])
    assert tmetrics.REGISTRY._default_budget is None
    assert ttracing.TRACER.store._retention is prev_policy
    with pytest.raises(tcfg.ConfigError, match="item 18b.3"):
        trun.main(["--config", str(_write(tmp_path, {"observability": {"nodeTopK": 5}}))],
                  stop_event=threading.Event())


def _write(tmp_path, config):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(config))
    return path
