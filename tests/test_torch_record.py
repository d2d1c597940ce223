"""The flight recorder (``nos_tpu_torch/record/recorder.py``) and
``/debug/record`` against nos_tpu's (``tests/record/test_recorder.py``,
``tests/record/test_endpoints.py``).

The ring's bound and order, the session header, the delta stream's
capture (revisions, types, the drain on ``detach``) and the JSONL round
trip, as the reference's tests hold them; every ``record_*`` method
called with the same arguments on both sides writes a record of the same
keys and values (but the clock stamps). The reference's recorder is
built bare (``object.__new__``, its ring set by hand): its constructor
would register with the reference's process-wide ``SIZES``, which no
parity test writes. The port's ``record.flight_ring`` registration is
removed after each test. Deltas use the flat wire: a pod's creation time
survives to the bit, so two pods created within one second keep their
order. ``/debug/record`` serves the ring as JSON and JSONL behind the
metrics bearer gate and answers 404 while recording is off.
"""
import collections
import http.client
import itertools
import json
import threading

import pytest

from nos_tpu.record import recorder as jrecorder
from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.kube import flatwire
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.store import (
    ConfigMap,
    Node,
    NodeStore,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    Taint,
    Toleration,
)
from nos_tpu_torch.record import FlightRecorder, load_jsonl
from nos_tpu_torch.record.recorder import RECORDED_KINDS
from nos_tpu_torch.timeline.sizes import SIZES
from nos_tpu_torch.util.health import HealthServer


@pytest.fixture(autouse=True)
def _forget_the_ring():
    yield
    SIZES.unregister("record.flight_ring")


def bare_reference_recorder():
    """The reference's recorder without its constructor's SIZES write."""
    fr = object.__new__(jrecorder.FlightRecorder)
    fr.capacity = 4096
    fr._ring = collections.deque(maxlen=4096)
    fr._seq = itertools.count(1)
    fr._lock = threading.Lock()
    return fr


class TestRing:
    def test_capacity_bounds_the_ring(self):
        fr = FlightRecorder(capacity=8)
        for i in range(50):
            fr.record_scheduler_cycle(pod=f"default/p{i}", revision=i, decision="fail")
        records = fr.records()
        assert len(records) == 8
        # the oldest, session.start among them, fell off; the tail is in order
        assert [r["pod"] for r in records] == [f"default/p{i}" for i in range(42, 50)]
        assert SIZES.sizes()["record.flight_ring"] == 8

    def test_seq_strictly_increasing(self):
        fr = FlightRecorder(capacity=16)
        for i in range(5):
            fr.record_actuation(kind="mig", plan_id=str(i), revision=i, applied=0)
        seqs = [r["seq"] for r in fr.records()]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)

    def test_concurrent_writers_keep_the_ring_in_seq_order(self):
        fr = FlightRecorder(capacity=10_000)

        def write(k):
            for i in range(200):
                fr.record_audit(revision=k * 1000 + i, violations=[])

        threads = [threading.Thread(target=write, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seqs = [r["seq"] for r in fr.records()]
        assert seqs == sorted(seqs) and len(seqs) == 801

    def test_stamps_read_the_clock_given(self):
        fr = FlightRecorder(clock=lambda: 42.5)
        fr.record_audit(revision=1, violations=[])
        assert [r["ts"] for r in fr.records()] == [42.5, 42.5]
        assert fr.records()[0]["wall_time"] == 42.5


class TestSessionMeta:
    def test_meta_folds_into_session_start(self):
        fr = FlightRecorder(seed=7)
        fr.record_session_meta(scheduler_name="nos", gang_timeout_seconds=3.0)
        fr.record_session_meta(aging_per_second=2.0)
        start = fr.records()[0]
        assert start["kind"] == "session.start" and start["seed"] == 7
        assert start["scheduler_name"] == "nos" and start["gang_timeout_seconds"] == 3.0
        assert start["aging_per_second"] == 2.0
        assert set(start) >= {"seq", "kind", "ts", "revision", "wall_time", "monotonic"}


class TestDeltaCapture:
    def test_attach_records_store_writes_with_revisions(self):
        fr = FlightRecorder()
        store = NodeStore()
        fr.attach(store)
        try:
            store.create(Pod("p1", request={"cpu": 1}))
            store.patch_merge("Pod", "p1", "default", lambda p: setattr(p, "phase", "Running"))
            store.delete("Pod", "p1", "default")
        finally:
            fr.detach()
        deltas = [r for r in fr.records() if r["kind"] == "delta"]
        assert [d["type"] for d in deltas] == ["ADDED", "MODIFIED", "DELETED"]
        revisions = [d["revision"] for d in deltas]
        assert revisions == sorted(revisions) == [1, 2, 3]
        assert deltas[0]["object"]["name"] == "p1" and deltas[0]["object"]["kind"] == "Pod"
        assert deltas[1]["object"]["phase"] == "Running"

    def test_existing_objects_replay_as_added_at_the_attach_revision(self):
        store = NodeStore()
        store.create(Node("n1"))
        store.create(Pod("p1"))
        fr = FlightRecorder()
        fr.attach(store)
        fr.detach()
        deltas = [r for r in fr.records() if r["kind"] == "delta"]
        assert [(d["type"], d["object"]["kind"], d["revision"]) for d in deltas] == [
            ("ADDED", "Node", 2), ("ADDED", "Pod", 2)]

    def test_events_and_unrecorded_kinds_stay_out(self):
        fr = FlightRecorder()
        store = NodeStore()
        fr.attach(store)
        pod = store.create(Pod("p1"))
        EventRecorder(store, component="test").record(pod, "Scheduled", "bound")
        fr.detach()
        kinds = [r["object"]["kind"] for r in fr.records() if r["kind"] == "delta"]
        assert kinds == ["Pod"]
        assert "Event" not in RECORDED_KINDS
        assert RECORDED_KINDS == jrecorder.RECORDED_KINDS

    def test_detach_drains_pending_events(self):
        fr = FlightRecorder()
        store = NodeStore()
        fr.attach(store)
        barrier = threading.Barrier(2)

        def writer():
            barrier.wait()
            for i in range(20):
                store.create(Pod(f"w{i}"))

        t = threading.Thread(target=writer)
        t.start()
        barrier.wait()
        t.join()
        fr.detach()
        assert len([r for r in fr.records() if r["kind"] == "delta"]) == 20

    def test_drain_records_what_is_queued_now(self):
        fr = FlightRecorder()
        store = NodeStore()
        fr.attach(store)
        try:
            fr._stop.set()  # park the drain thread: the test drains
            fr._thread.join()
            store.create(Pod("p1"))
            assert fr.drain() == 1
            assert fr.records()[-1]["object"]["name"] == "p1"
        finally:
            fr.detach()


def _objects():
    return [
        Pod("tied-a", "ns", request={"nvidia.com/mig-1g.10gb": 1}, priority=3,
            labels={"a": "b"}, tolerations=[Toleration("k", "Exists")], created=1000.25,
            uid="uid-7", pod_affinity=[PodAffinityTerm("zone", {"x": "y"})],
            annotations={"k": "v"}, nominated_node="n1", unschedulable=True,
            unschedulable_message="no room", resource_version=9),
        Pod("tied-b", "ns", created=1000.75),
        Node("n1", labels={"l": "v"}, capacity={"nvidia.com/gpu": 8},
             allocatable={"nvidia.com/gpu": 8}, annotations={"a": "1"},
             taints=[Taint("t", "v", "NoSchedule")], unschedulable=True),
        ConfigMap("cm", "kube-system", data={"k": "v"}, labels={"l": "1"}),
        PodDisruptionBudget("pdb", selector={"app": "x"}, min_available=2),
        ElasticQuota("q", "team-a", min={"nos.nebuly.com/gpu-memory": 80},
                     max={"nos.nebuly.com/gpu-memory": 160}, used={"x": 1}),
        CompositeElasticQuota("c", "default", namespaces=["a", "b"],
                              min={"nos.nebuly.com/gpu-memory": 40}),
    ]


class TestFlatWire:
    @pytest.mark.parametrize("obj", _objects(), ids=lambda o: f"{o.kind}-{o.name}")
    def test_every_recorded_kind_round_trips_through_json(self, obj):
        doc = json.loads(json.dumps(flatwire.to_wire(obj)))
        assert doc["kind"] == obj.kind
        assert flatwire.from_wire(doc) == obj
        assert obj.kind in RECORDED_KINDS

    def test_pods_tied_within_one_second_keep_their_creation_times(self):
        a, b = _objects()[:2]
        got = [flatwire.from_wire(json.loads(json.dumps(flatwire.to_wire(p)))) for p in (a, b)]
        assert [p.created for p in got] == [1000.25, 1000.75]

    def test_an_unrecorded_kind_has_no_document(self):
        from nos_tpu_torch.kube.store import Event

        with pytest.raises(KeyError):
            flatwire.to_wire(Event("e"))


class TestJsonl:
    def test_export_load_round_trip(self, tmp_path):
        fr = FlightRecorder()
        fr.record_scheduler_cycle(pod="default/p1", revision=3, decision="bind", node="n1",
                                  bound=[["default/p1", "n1"]])
        fr.record_plan(kind="mig", revision=4, pending=["default/p1"],
                       pending_ages={"default/p1": 1.5}, plan_id="42-1",
                       desired={"n1": {"0": {"nvidia.com/mig-7g.80gb": 1}}}, unserved={},
                       applied=1)
        path = tmp_path / "rec.jsonl"
        count = fr.export_jsonl(str(path))
        loaded = load_jsonl(str(path))
        assert count == len(loaded) == 3
        assert loaded == fr.records()
        assert loaded[1]["decision"] == "bind"
        assert loaded[2]["partitioner_kind"] == "mig"
        assert loaded[2]["pending_ages"] == {"default/p1": 1.5}
        assert fr.to_jsonl().splitlines() == [json.dumps(r, sort_keys=True) for r in loaded]


# (method, keyword arguments) of every decision record, called alike on both sides
CALLS = [
    ("record_scheduler_cycle", dict(pod="ns/p", revision=3, decision="fail", node="",
                                    bound=None, victims=["ns/v"], message="0/2 nodes",
                                    trace_id="t1", diagnosis={"pod": "ns/p"}, settled=False)),
    ("record_plan", dict(kind="mig", revision=4, pending=["ns/p"], pending_ages={"ns/p": 2.0},
                         plan_id="9-1", desired={"n": {"0": {"r": 1}}},
                         unserved={"ns/p": "lacking"}, applied=1, trace_id="t2")),
    ("record_quota_reconcile", dict(quota="team-a/q", revision=5, used={"m": 40},
                                    flips=[["team-a/p", "over-quota"]])),
    ("record_actuation", dict(kind="mps", plan_id="9-2", revision=6, applied=0)),
    ("record_pool_escalation", dict(kind="mig", pool="pool-a", revision=7, reason="dead")),
    ("record_audit", dict(revision=8, violations=[{"check": "free_pool"}])),
    ("record_capacity", dict(revision=9, now=12.5, reason="queued", totals={"total": 1.0},
                             trace_id="t3")),
    ("record_forecast", dict(revision=10, now=13.0, gangs=[{"gang": "g"}], backfill_unsafe=2,
                             advisor_validated=True, trace_id="t4")),
    ("record_forecast_outcome", dict(gang="ns/g", now=14.0, stage="blocked", eta_seconds=3.0,
                                     actual_seconds=4.0, wait_seconds=5.0,
                                     calibration={"samples": 1})),
    ("record_timeline_finding", dict(t=15.0, detector="stall", series="loop.x",
                                     window=[[1.0, 2.0]], params={"min_samples": 3},
                                     verdict={"stalled_for": 1.0}, stacks=None)),
]
STAMPS = {"seq", "ts", "monotonic"}


@pytest.mark.parametrize("method,kwargs", CALLS, ids=[c[0] for c in CALLS])
def test_each_record_kind_equals_the_references(method, kwargs):
    port, ref = FlightRecorder(), bare_reference_recorder()
    getattr(port, method)(**kwargs)
    getattr(ref, method)(**kwargs)
    got, want = port.records()[-1], ref.records()[-1]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in STAMPS} == {
        k: v for k, v in want.items() if k not in STAMPS}


def _get(port, path, token=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path, headers={"Authorization": f"Bearer {token}"} if token else {})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


class TestDebugRecordEndpoint:
    def test_serves_the_ring_as_json_and_jsonl(self):
        fr = FlightRecorder()
        fr.record_scheduler_cycle(pod="default/p1", revision=1, decision="bind", node="n1")
        server = HealthServer(port=0, record_fn=fr.records)
        port = server.start()
        try:
            status, body = _get(port, "/debug/record")
            assert status == 200
            records = json.loads(body)
            assert records[0]["kind"] == "session.start" and records[1]["decision"] == "bind"
            status, body = _get(port, "/debug/record?format=jsonl")
            assert status == 200
            assert [json.loads(line) for line in body.splitlines() if line] == records
            status, body = _get(port, "/debug/")
            assert "/debug/record" in json.loads(body)["endpoints"]
        finally:
            server.stop()

    def test_shares_the_metrics_bearer_gate(self):
        server = HealthServer(port=0, metrics_token="s3cret", record_fn=FlightRecorder().records)
        port = server.start()
        try:
            assert _get(port, "/debug/record")[0] == 401
            assert _get(port, "/debug/record", "wrong")[0] == 401
            assert _get(port, "/debug/record", "s3cret")[0] == 200
        finally:
            server.stop()

    def test_404_when_recording_is_off(self):
        server = HealthServer(port=0)
        port = server.start()
        try:
            assert _get(port, "/debug/record")[0] == 404
            assert "/debug/record" not in json.loads(_get(port, "/debug/")[1])["endpoints"]
        finally:
            server.stop()
