"""Trace retention, export, logging and the events' trace id
(nos_tpu_torch.util.tracing, kube/events.py) against nos_tpu.util.tracing.

- Retention: the same constructed traces (roots and children, errors,
  diagnoses, slow and fast roots, fixed ids and clocks) under several
  ``RetentionPolicy``s go through fresh ``TraceStore``s on both sides:
  ``classify_trace``, the kept ids in order, ``summaries``, every page of
  ``summaries_page`` and ``retention_stats`` are exactly equal, after a
  policy swap too.
- Export: ``Span.to_chrome_events`` and ``Trace.to_chrome`` of the same
  spans are equal; one span program run on a fresh ``Tracer`` of each
  side (nesting, events, an error, ``attach`` across a thread, a late
  span, ``plugin_span`` under ``suppress_plugins``) gives the same Chrome
  export once ids and clocks are normalised.
- Logging: ``TraceContextFilter`` and ``JsonLogFormatter`` write the same
  record fields and line under a span and outside one.
- Events: an event recorded under a span carries its trace id in
  ``nos.nebuly.com/trace-id``, a repeat points it at the latest trace, and
  the annotation is no part of the event's name (the reference's digest).

Only fresh tracers and stores are written; the process's tracers are not.
"""
import io
import json
import logging
import re
import threading

import pytest

from nos_tpu.kube.events import TRACE_ID_ANNOTATION as REF_TRACE_ID_ANNOTATION
from nos_tpu.kube.events import EventRecorder as RefEventRecorder
from nos_tpu.util import tracing as jt
from nos_tpu_torch.util import tracing as tt


def _trace(mod, i, *, status="ok", diagnosis=False, duration=0.1, children=2,
           root_name="pod.journey"):
    tid = f"t{i:04d}"
    attrs = {"pod": f"default/p{i}"}
    if diagnosis:
        attrs["diagnosis"] = "0/3 nodes are available"
    root = mod.Span(name=root_name, trace_id=tid, span_id=f"{tid}-r", attributes=attrs,
                    start_wall=1000.0 + i, duration_s=duration, thread="w")
    spans = [root]
    for c in range(children):
        spans.append(mod.Span(name=("plan", "bind")[c % 2], trace_id=tid,
                              span_id=f"{tid}-{c}", parent_id=root.span_id,
                              start_wall=1000.0 + i + c * 0.01, duration_s=0.01 * (c + 1),
                              status=status if c == 0 else "ok"))
    return mod.Trace(trace_id=tid, spans=spans, dropped_spans=i % 3)


def _mixture(mod, n=400):
    out = []
    for i in range(n):
        if i % 37 == 0:
            out.append(_trace(mod, i, status="error"))
        elif i % 23 == 0:
            out.append(_trace(mod, i, diagnosis=True))
        elif i % 11 == 0:
            out.append(_trace(mod, i, duration=3.0))
        elif i % 13 == 0:
            out.append(_trace(mod, i, duration=3.0, root_name="plan.cycle"))
        else:
            out.append(_trace(mod, i, children=i % 4))
    return out


POLICIES = [dict(), dict(tail_capacity=0), dict(tail_capacity=8, boring_sample_n=4,
                                                slow_thresholds={"pod.journey": 1.0}),
            dict(tail_capacity=64, boring_sample_n=1,
                 slow_thresholds={"pod.journey": 2.0, "plan.cycle": 5.0})]


@pytest.mark.parametrize("policy", POLICIES, ids=[str(i) for i in range(len(POLICIES))])
@pytest.mark.parametrize("capacity", [16, 256])
def test_retention_equals_the_references(policy, capacity):
    ref = jt.TraceStore(capacity, retention=jt.RetentionPolicy(**policy))
    port = tt.TraceStore(capacity, retention=tt.RetentionPolicy(**policy))
    for r, p in zip(_mixture(jt), _mixture(tt)):
        assert tt.classify_trace(p, port._retention) == jt.classify_trace(r, ref._retention)
        ref.add(r)
        port.add(p)
    assert [t.trace_id for t in port.list()] == [t.trace_id for t in ref.list()]
    assert port.summaries() == ref.summaries()
    assert port.retention_stats() == ref.retention_stats()
    assert len(port) == len(ref)
    for limit in (0, 1, 7, 50):
        cursor, pages = "", 0
        while True:
            got = port.summaries_page(limit=limit, cursor=cursor)
            assert got == ref.summaries_page(limit=limit, cursor=cursor)
            pages += 1
            cursor = got[1]
            if not cursor:
                break
        assert pages == (1 if not limit else max(1, -(-len(port) // limit)))
    for tid in ("t0000", "t0023", "t0399", "missing"):
        assert (port.get(tid) is None) == (ref.get(tid) is None)
    # a swap to a smaller reservoir evicts the oldest pinned traces
    prev_ref = ref.set_retention(jt.RetentionPolicy(tail_capacity=2))
    prev_port = port.set_retention(tt.RetentionPolicy(tail_capacity=2))
    assert prev_port.__dict__ == prev_ref.__dict__
    assert port.summaries() == ref.summaries()
    assert port.retention_stats() == ref.retention_stats()
    port.clear()
    assert len(port) == 0 and port.retention_stats()["seen"] == {}


def test_a_pinned_trace_survives_a_boring_burst():
    store = tt.TraceStore(8, retention=tt.RetentionPolicy(tail_capacity=4))
    store.add(_trace(tt, 0, status="error"))
    for i in range(1, 200):
        store.add(_trace(tt, i))
    assert store.get("t0000") is not None
    assert store.retention_stats()["hit_rate"] == 1.0


def test_chrome_export_of_the_same_spans_is_equal():
    for r, p in zip(_mixture(jt, 40), _mixture(tt, 40)):
        r.spans[0].add_event("admitted", node="n1")
        p.spans[0].add_event("admitted", node="n1")
        r.spans[0].events[-1] = (1234.5, *r.spans[0].events[-1][1:])
        p.spans[0].events[-1] = (1234.5, *p.spans[0].events[-1][1:])
        assert p.to_chrome() == r.to_chrome()
        assert p.summary() == r.summary()


def _program(mod):
    """One span program on a fresh tracer of ``mod``; its stored traces."""
    tracer = mod.Tracer(capacity=64)
    with tracer.span("cycle", pod="a") as root:
        root.set_attribute("nodes", 3)
        root.add_event("start", n=1)
        with tracer.span("plan"):
            with tracer.suppress_plugins():
                with tracer.plugin_span("filter") as hidden:
                    assert hidden is mod.NOOP_SPAN
            with tracer.plugin_span("score"):
                pass
        out = {}

        def worker():
            with tracer.attach(root):
                with tracer.span("actuate", node="n1"):
                    out["phase"] = mod.current_phase(threading.get_ident())

        t = threading.Thread(target=worker, name="w")
        t.start()
        t.join()
        assert out["phase"] == "actuate"
        with pytest.raises(ValueError):
            with tracer.span("bind"):
                raise ValueError("boom")
        late = tracer.start_span("late")
    tracer.end_span(late)  # after the root: joins the stored trace
    assert tracer.plugin_span("outside") is not None
    with tracer.plugin_span("outside") as outside:
        assert outside is mod.NOOP_SPAN  # no open trace
    root_j = tracer.journey_root(("pod", "x"), "pod.journey", pod="x")
    assert tracer.journey_root(("pod", "x"), "pod.journey") is root_j
    with tracer.span("observe", parent=root_j):
        pass
    tracer.end_journey(("pod", "x"), status="ok", node="n2")
    traces = tracer.store.list()
    tracer.reset()
    assert len(tracer.store) == 0
    return traces


def _normalise(traces):
    ids = {}

    def norm(value):
        if isinstance(value, str) and re.fullmatch(r"[ts][0-9a-f]+", value):
            return ids.setdefault(value, f"{value[0]}{len(ids)}")
        return value

    out = []
    for trace in traces:
        doc = trace.to_chrome()
        doc["otherData"]["trace_id"] = norm(doc["otherData"]["trace_id"])
        for ev in doc["traceEvents"]:
            ev.pop("ts")  # the clocks differ run to run
            ev.pop("dur", None)
            ev["args"] = {k: norm(v) for k, v in ev["args"].items()}
            ev["tid"] = "main" if ev["tid"] == "MainThread" else ev["tid"]
        out.append(doc)
    return out


def test_the_same_span_program_exports_the_same_chrome_trace():
    port, ref = _program(tt), _program(jt)
    assert [len(t.spans) for t in port] == [len(t.spans) for t in ref] == [2, 6]
    assert _normalise(port) == _normalise(ref)
    cycle = port[1]
    assert {s.name: s.status for s in cycle.spans}["bind"] == "error"
    assert cycle.summary()["stages"]["bind"]["count"] == 1


def _log_line(mod, formatter, span_ids):
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.addFilter(mod.TraceContextFilter())
    handler.setFormatter(formatter)
    logger = logging.getLogger(f"parity.{mod.__name__}")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    tracer = mod.Tracer()
    try:
        logger.info("outside %s", "a span")
        with tracer.span("cycle") as span:
            span_ids.append((span.trace_id, span.span_id))
            logger.info("inside %d", 3)
            try:
                raise KeyError("k")
            except KeyError:
                logger.exception("failed")
    finally:
        logger.removeHandler(handler)
    return stream.getvalue().splitlines()


def test_the_log_filter_and_formatter_write_the_references_fields():
    ours, theirs = [], []
    port = _log_line(tt, tt.JsonLogFormatter(), ours)
    ref = _log_line(jt, jt.JsonLogFormatter(), theirs)
    port_docs = [json.loads(x) for x in port if x.startswith("{")]
    ref_docs = [json.loads(x) for x in ref if x.startswith("{")]
    assert len(port_docs) == len(ref_docs) == 3
    for p, r in zip(port_docs, ref_docs):
        assert sorted(p) == sorted(r)
        assert (p["level"], p["message"]) == (r["level"], r["message"])
    assert "trace_id" not in port_docs[0]
    assert (port_docs[1]["trace_id"], port_docs[1]["span_id"]) == ours[0]
    assert port_docs[2]["exc"].splitlines()[-1] == "KeyError: 'k'"
    plain = _log_line(tt, logging.Formatter("[%(trace_id)s|%(span_id)s] %(message)s"), ours)
    assert plain[0] == "[|] outside a span"
    assert plain[1] == f"[{ours[1][0]}|{ours[1][1]}] inside 3"


def test_configure_logging_attaches_the_filter():
    stream = io.StringIO()
    handler = tt.configure_logging(json_format=True, level=logging.INFO, stream=stream,
                                   logger_name="nos_tpu_torch.parity")
    try:
        logging.getLogger("nos_tpu_torch.parity.x").info("hello")
    finally:
        logging.getLogger("nos_tpu_torch.parity").removeHandler(handler)
    doc = json.loads(stream.getvalue())
    assert doc["logger"] == "nos_tpu_torch.parity.x" and doc["message"] == "hello"


def test_an_event_carries_the_trace_of_the_decision_that_recorded_it():
    from nos_tpu_torch.kube.events import TRACE_ID_ANNOTATION, EventRecorder
    from nos_tpu_torch.kube.objects import Pod
    from nos_tpu_torch.kube.store import NodeStore
    from nos_tpu_torch.util.tracing import TRACER

    assert TRACE_ID_ANNOTATION == REF_TRACE_ID_ANNOTATION
    store = NodeStore()
    pod = store.create(Pod("p", "default"))
    rec = EventRecorder(store, component="test", clock=lambda: 5.0)
    plain = rec.record(pod, "FailedScheduling", "no node")
    assert TRACE_ID_ANNOTATION not in plain.annotations
    with TRACER.span("cycle-1") as first:
        ev = rec.record(pod, "FailedScheduling", "no node")
    assert ev.name == plain.name and ev.count == 2  # the id is outside the digest
    assert ev.annotations[TRACE_ID_ANNOTATION] == first.trace_id
    with TRACER.span("cycle-2") as second:
        ev = rec.record(pod, "FailedScheduling", "no node")
    assert ev.annotations[TRACE_ID_ANNOTATION] == second.trace_id and ev.count == 3
    with TRACER.span("cycle-3") as third:
        fresh = rec.record(pod, "Scheduled", "bound to n1")
    assert fresh.count == 1 and fresh.annotations[TRACE_ID_ANNOTATION] == third.trace_id
    # the name is the reference's digest of (kind, ns, name, reason, message)
    assert plain.name == RefEventRecorder._event_name("Pod", "default", "p", "FailedScheduling",
                                                      "no node")
