"""Events and leader election (nos_tpu_torch.kube.events /
leaderelection) against nos_tpu.kube.events / leaderelection, on
injected clocks.

- Events: one seeded sequence of records (pods, nodes, reasons,
  messages, clock advances) runs through the reference's recorder on its
  store and the port's on its, with a small burst so the token buckets
  drop: the same records are stored or dropped, the same events stand
  (name, namespace, the object, reason, message, type, count, first and
  last time, source) and ``events_for`` answers the same. The reference's
  cases (tests/kube/test_events.py): an unknown reason raises, a node's
  events land in ``default``, a second recorder dedups into the first's
  event, and the record path works over the API-backed store.
- Leader election: two electors a side on one store, driven step by step
  on one fake monotonic clock and one skewed wall clock (the reference's
  module clock pointed at it): a acquires, b is held while a renews, a
  goes silent and b takes over a lease later, b releases and a takes the
  lease at once, a store outage keeps the leader within its deadline and
  demotes it after, and renew stamps that change but run backwards never
  let a challenger in. Every step gives the same leaders, callbacks and
  lease annotations on both sides. The threaded path (``start`` /
  ``stop``, ``wait_for_leadership``) hands over on a release, and over the
  API-backed store exactly one of two electors leads.
"""
import random
import threading
import time as real_time

import pytest

from nos_tpu.kube import events as jevents
from nos_tpu.kube import leaderelection as jle
from nos_tpu.kube.store import KubeStore
from nos_tpu_torch.kube import leaderelection as tle
from nos_tpu_torch.kube.apiclient import ClusterCredentials, KubeApiClient
from nos_tpu_torch.kube.apistore import KubeApiStore
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.objects import Node, Pod
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.sim.apiserver import StubApiServer
from tests.torch_kube_cases import to_ref

REASONS = ("FailedScheduling", "Scheduled", "Preempted", "PartitioningApplied")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _event_view(e):
    meta = getattr(e, "metadata", e)
    return (meta.name, meta.namespace, e.involved_kind, e.involved_namespace, e.involved_name,
            e.reason, e.message, e.type, e.count, e.first_timestamp, e.last_timestamp,
            e.source_component)


@pytest.mark.parametrize("seed", range(6))
def test_records_dedup_and_drop_as_the_reference(seed):
    rng = random.Random(seed)
    clock = Clock()
    jstore, tstore = KubeStore(), NodeStore()
    jrec = jevents.EventRecorder(jstore, "sched", burst=3, refill_per_second=0.2, clock=clock)
    trec = EventRecorder(tstore, "sched", burst=3, refill_per_second=0.2, clock=clock)
    objects = [Pod("train", "ml"), Pod("serve", "default"), Node("n1")]
    outcomes = []
    for _ in range(60):
        if rng.random() < 0.2:
            clock.t += rng.choice([0.5, 3.0, 10.0])
        obj = rng.choice(objects)
        reason, message = rng.choice(REASONS), rng.choice(["no fit", "carved", "bound"])
        kind = rng.choice(["Normal", "Warning"])
        outcomes.append((jrec.record(to_ref(obj), reason, message, type=kind) is None,
                         trec.record(obj, reason, message, type=kind) is None))
    assert [t for _, t in outcomes] == [r for r, _ in outcomes]
    assert jrec.dropped == trec.dropped > 0
    stored = sorted(_event_view(e) for ns in ("ml", "default") for e in jstore.list("Event", ns))
    assert sorted(_event_view(e) for e in tstore.list("Event")) == stored
    assert max(v[8] for v in stored) > 1  # some count was bumped
    for obj in objects:
        assert [_event_view(e) for e in trec.events_for(obj)] == [
            _event_view(e) for e in jrec.events_for(to_ref(obj))]


def test_unknown_reasons_raise_and_node_events_land_in_default():
    rec = EventRecorder(NodeStore(), clock=Clock())
    with pytest.raises(ValueError, match="EVENT_REASONS"):
        rec.record(Pod("p"), "MadeUpReason", "msg")
    rec.record(Node("n1"), "PartitioningApplied", "carved")
    (event,) = rec.store.list("Event", namespace="default")
    assert (event.involved_kind, event.involved_namespace, event.count) == ("Node", "", 1)


def test_a_second_recorder_bumps_the_first_ones_event():
    store, clock = NodeStore(), Clock()
    EventRecorder(store, clock=clock).record(Pod("p"), "Scheduled", "bound")
    clock.t += 5
    ev = EventRecorder(store, clock=clock).record(Pod("p"), "Scheduled", "bound")
    assert (ev.count, ev.first_timestamp, ev.last_timestamp) == (2, 1000.0, 1005.0)
    assert len(store.list("Event")) == 1


def test_records_dedup_through_the_api_store():
    api = StubApiServer().start()
    try:
        store = KubeApiStore(KubeApiClient(ClusterCredentials(server=api.url), timeout=5.0),
                             kinds=("Event",))
        store.start(sync_timeout_s=10.0)
        try:
            clock = Clock(1_767_225_600.0)
            rec = EventRecorder(store, "sched", clock=clock)
            rec.record(Pod("p", "ml"), "FailedScheduling", "no fit", type="Warning")
            clock.t += 2
            ev = rec.record(Pod("p", "ml"), "FailedScheduling", "no fit", type="Warning")
            assert ev.count == 2 and ev.last_timestamp == clock.t
            wire = api.read("events", "ml", ev.name)
            assert wire["count"] == 2 and wire["involvedObject"]["name"] == "p"
            assert [e.count for e in rec.events_for(Pod("p", "ml"))] == [2]
        finally:
            store.stop()
    finally:
        api.stop()


# ------------------------------------------------------------ leader election


class FakeTime:
    def __init__(self, clock):
        self.monotonic = clock
        self.time = clock
        self.sleep = real_time.sleep


def _ref_step(e):
    """The reference's ``run`` loop body (its one attempt and transition)."""
    with e._lease_lock:
        try:
            got = e._try_acquire_or_renew()
        except Exception:
            got = e.is_leader and jle.time.monotonic() - e._last_renew_ok < e.lease_duration_s
        else:
            if got:
                e._last_renew_ok = jle.time.monotonic()
        if got and not e.is_leader:
            e.is_leader = True
            if e.on_started_leading:
                e.on_started_leading()
        elif not got and e.is_leader:
            e.is_leader = False
            if e.on_stopped_leading:
                e.on_stopped_leading()
    return e.is_leader


class Side:
    """Two electors on one store, with their callbacks' log."""

    def __init__(self, port, mono, wall):
        self.port = port
        self.store = NodeStore() if port else KubeStore()
        self.log = []
        self.electors = {}
        for ident in ("a", "b"):
            kw = dict(name="lease", identity=ident, lease_duration_s=10.0, renew_period_s=2.0,
                      on_started_leading=lambda i=ident: self.log.append(f"{i}-up"),
                      on_stopped_leading=lambda i=ident: self.log.append(f"{i}-down"))
            if port:
                e = tle.LeaderElector(self.store, monotonic=mono, wall_clock=wall, **kw)
            else:
                e = jle.LeaderElector(self.store, **kw)
                e.wall_clock = wall
            self.electors[ident] = e

    def step(self, ident):
        e = self.electors[ident]
        return e.step() if self.port else _ref_step(e)

    def lease(self):
        cm = self.store.try_get("ConfigMap", "lease", "nos-system")
        if cm is None:
            return None
        ann = cm.annotations if self.port else cm.metadata.annotations
        return dict(ann)


def test_leader_election_steps_as_the_reference(monkeypatch):
    mono, wall = Clock(), Clock(5.0)
    monkeypatch.setattr(jle, "time", FakeTime(mono))
    ref, port = Side(False, mono, wall), Side(True, mono, wall)
    trace = []

    def both(*steps, advance=0.0, wall_step=1.0):
        mono.t += advance
        wall.t += wall_step
        for ident in steps:
            got = (ref.step(ident), port.step(ident))
            assert got[0] == got[1], (ident, mono.t)
            trace.append(got[0])
        assert port.lease() == ref.lease()
        assert port.log == ref.log

    both("a", "b")  # a acquires, b first sees a's lease
    for _ in range(4):
        both("a", "b", advance=4.0)  # a renews: b stays out
    for _ in range(2):
        both("b", advance=6.0)  # a goes silent: b takes over past a lease
    assert port.log[-1] == "b-up" and ref.electors["b"].is_leader
    both("a", advance=1.0)  # a finds b's lease and steps down
    ref.electors["b"].release()
    port.electors["b"].release()
    both("a")  # the released lease is a's at once
    assert port.log[-2:] == ["b-down", "a-up"]

    # an outage: the leader keeps its lease within the deadline, then not
    def broken(*a, **k):
        raise OSError("connection refused")

    for side in (ref, port):
        monkeypatch.setattr(side.store, "patch_merge", broken)
    both("a", advance=4.0)
    assert port.electors["a"].is_leader
    both("a", advance=7.0)
    assert not port.electors["a"].is_leader and port.log[-1] == "a-down"
    monkeypatch.undo()
    monkeypatch.setattr(jle, "time", FakeTime(mono))
    both("a", "b", advance=1.0)

    # a skewed holder whose stamps change, backwards, is never expired
    for side in (ref, port):
        patch = {tle.HOLDER_ANNOTATION: "skewed", tle.RENEW_ANNOTATION: "900"}
        side.store.patch_annotations("ConfigMap", "lease", "nos-system", patch)
    for i in range(5):
        for side in (ref, port):
            side.store.patch_annotations("ConfigMap", "lease", "nos-system",
                                         {tle.RENEW_ANNOTATION: str(800 - i)})
        both("a", "b", advance=6.0, wall_step=-100.0)
    assert not any(e.is_leader for e in port.electors.values())
    both("a", advance=11.0)  # silent a whole lease: a takes it
    assert port.electors["a"].is_leader
    assert trace.count(True) > 5 and trace.count(False) > 5


def test_a_release_hands_over_on_the_threaded_path():
    store = NodeStore()
    events = []
    a = tle.LeaderElector(store, "lease", "a", lease_duration_s=0.5, renew_period_s=0.05,
                          on_started_leading=lambda: events.append("a-up"),
                          on_stopped_leading=lambda: events.append("a-down"))
    b = tle.LeaderElector(store, "lease", "b", lease_duration_s=0.5, renew_period_s=0.05,
                          on_started_leading=lambda: events.append("b-up"))
    a.start()
    try:
        assert a.wait_for_leadership(5.0)
        b.start()
        assert not b.wait_for_leadership(0.2)
        a.stop()  # a clean stop releases
        assert b.wait_for_leadership(5.0)
        assert events == ["a-up", "a-down", "b-up"]
    finally:
        a.stop()
        b.stop()


def test_exactly_one_of_two_electors_leads_over_the_api_store():
    api = StubApiServer().start()
    stores = [KubeApiStore(KubeApiClient(ClusterCredentials(server=api.url), timeout=5.0),
                           kinds=("ConfigMap",)) for _ in range(2)]
    electors = []
    try:
        for s in stores:
            s.start(sync_timeout_s=10.0)
        electors = [tle.LeaderElector(s, "lease", ident, lease_duration_s=0.5,
                                      renew_period_s=0.05) for s, ident in zip(stores, "ab")]
        for e in electors:
            e.start()
        deadline = real_time.monotonic() + 5
        while real_time.monotonic() < deadline and not any(e.is_leader for e in electors):
            real_time.sleep(0.02)
        stop = threading.Event()
        both = []

        def watch():
            while not stop.is_set():
                both.append(sum(e.is_leader for e in electors))
                real_time.sleep(0.005)

        t = threading.Thread(target=watch)
        t.start()
        real_time.sleep(0.3)
        stop.set()
        t.join(5)
        assert max(both) == 1 and both[-1] == 1
    finally:
        for e in electors:
            e.stop()
        for s in stores:
            s.stop()
        api.stop()
