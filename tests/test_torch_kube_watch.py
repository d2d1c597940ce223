"""The node store's watches, versions and indexers
(nos_tpu_torch.kube.store) against nos_tpu.kube.store.KubeStore.

- Seeded random sequences of creates, updates (some with a stale
  resource version), patches, deletes and missing-object writes run on
  both stores, the reference's objects the counterparts of the port's
  (``tests/torch_kube_cases.py``). Two watches on each side, one opened
  first (every kind) and one opened midway (pods; its replay of the
  existing objects included), deliver the same streams of (type, kind,
  namespace, name, resource version); the same writes raise
  ``ConflictError`` / ``NotFoundError`` / ``AlreadyExistsError``; and the
  pod indexers (node, phase) answer the same names in the same order
  after every write.
- The reference's own cases (tests/kube/test_store.py,
  test_store_index.py, test_revisions.py) on the port: copies, the
  version bumps of every write, a delete's version on its watch event,
  ``apply_event`` keeping recorded versions and the index, late indexer
  registration, ``copy=False`` identity, the watchers' depth gauges and
  stats, the drain-lag stamps, and the lock's contention meters.
"""
import queue
import random
import threading
import time

import pytest

from nos_tpu.kube import store as jstore
from nos_tpu_torch.kube.objects import ConfigMap, Node, Pod
from nos_tpu_torch.kube.store import (
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExistsError,
    ConflictError,
    NodeStore,
    NotFoundError,
    WatchEvent,
)
from nos_tpu_torch.util import metrics
from tests.torch_kube_cases import random_pod, ref_view, to_ref

ERRORS = {jstore.ConflictError: "conflict", ConflictError: "conflict",
          jstore.NotFoundError: "missing", NotFoundError: "missing",
          jstore.AlreadyExistsError: "exists", AlreadyExistsError: "exists"}


def _outcome(fn):
    try:
        fn()
        return None
    except tuple(ERRORS) as e:
        return ERRORS[type(e)]


def _drain(q):
    out = []
    while True:
        try:
            out.append(ref_view(q.get_nowait().object) + (None,))
        except queue.Empty:
            return out


def _events(q):
    out = []
    while True:
        try:
            e = q.get_nowait()
        except queue.Empty:
            return out
        out.append((e.type,) + ref_view(e.object))


def _indexed(ref, port):
    r, p = [], []
    for index, values in (("spec.nodeName", ("n0", "n1", "")), ("status.phase",
                                                                ("Pending", "Running"))):
        for v in values:
            r.append([(o.metadata.namespace, o.metadata.name, o.metadata.resource_version)
                      for o in ref.list_by_index("Pod", index, v)])
            p.append([(o.namespace, o.name, o.resource_version)
                      for o in port.list_by_index("Pod", index, v)])
    return r, p


@pytest.mark.parametrize("seed", range(6))
def test_random_writes_give_the_same_watch_streams_conflicts_and_indexes(seed):
    rng = random.Random(seed)
    ref, port = jstore.KubeStore(), NodeStore()
    for s in (ref, port):
        s.add_indexer("Pod", "spec.nodeName",
                      (lambda p: [p.spec.node_name]) if s is ref else (lambda p: [p.node]))
        s.add_indexer("Pod", "status.phase",
                      (lambda p: [p.status.phase]) if s is ref else (lambda p: [p.phase]))
    watches = [(ref.watch(), port.watch())]
    names = [f"p{i}" for i in range(6)]
    outcomes = []
    for step in range(60):
        if step == 30:
            watches.append((ref.watch(["Pod"], name="late"), port.watch(["Pod"], name="late")))
        op = rng.random()
        name = rng.choice(names)
        if op < 0.3:
            pod = random_pod(rng, name)
            pod.namespace, pod.resource_version, pod.uid = "default", 0, ""
            r = to_ref(pod)
            outcomes.append((_outcome(lambda: ref.create(r)), _outcome(lambda: port.create(pod))))
        elif op < 0.5:
            stale = rng.random() < 0.4
            node = rng.choice(["", "n0", "n1"])

            def ref_update():
                obj = ref.get("Pod", name, "default")
                obj.spec.node_name = node
                if stale:
                    obj.metadata.resource_version -= 1
                ref.update(obj, check_version=True)

            def port_update():
                obj = port.get("Pod", name, "default")
                obj.node = node
                if stale:
                    obj.resource_version -= 1
                port.update(obj, check_version=True)

            outcomes.append((_outcome(ref_update), _outcome(port_update)))
        elif op < 0.65:
            phase = rng.choice(["Pending", "Running", "Succeeded"])
            outcomes.append((
                _outcome(lambda: ref.patch_merge("Pod", name, "default",
                                                 lambda p: setattr(p.status, "phase", phase))),
                _outcome(lambda: port.patch_merge("Pod", name, "default",
                                                  lambda p: setattr(p, "phase", phase)))))
        elif op < 0.75:
            label = {"team": rng.choice(["a", "b", None])}
            outcomes.append((_outcome(lambda: ref.patch_labels("Pod", name, "default", label)),
                             _outcome(lambda: port.patch_labels("Pod", name, "default", label))))
        elif op < 0.85:
            outcomes.append((_outcome(lambda: ref.delete("Pod", name, "default")),
                             _outcome(lambda: port.delete("Pod", name, "default"))))
        else:
            cm = ConfigMap(f"cm{rng.randrange(2)}", "ml", {"k": str(step)})
            outcomes.append((_outcome(lambda: ref.create(to_ref(cm))),
                             _outcome(lambda: port.create(cm))))
        r_idx, p_idx = _indexed(ref, port)
        assert p_idx == r_idx
        assert port.version == ref.revision
    assert [p for _, p in outcomes] == [r for r, _ in outcomes]
    assert {"missing", "exists"} <= {r for r, _ in outcomes}
    for rq, pq in watches:
        r_events, p_events = _events(rq), _events(pq)
        assert p_events == r_events and r_events


# ------------------------------------------------- the reference's own cases


def make_pod(name, node="", phase="Pending", ns="default"):
    return Pod(name, ns, node=node, phase=phase, request={"cpu": 1})


def make_store():
    s = NodeStore()
    s.add_indexer("Pod", "status.phase", lambda p: [p.phase])
    s.add_indexer("Pod", "spec.nodeName", lambda p: [p.node])
    return s


def test_create_get_round_trip_is_isolated_and_update_bumps_the_version():
    s = NodeStore()
    created = s.create(make_pod("p1"))
    created.labels["x"] = "y"
    assert s.get("Pod", "p1", "default").labels == {}
    rv = created.resource_version
    updated = s.update(created)
    assert updated.resource_version > rv and s.revision == updated.resource_version
    s.patch_labels("Pod", "p1", "default", {"c": "d"})
    rv_patch = s.revision
    s.delete("Pod", "p1", "default")
    assert s.revision > rv_patch
    with pytest.raises(NotFoundError):
        s.update(make_pod("gone"))


def test_a_stale_update_conflicts_on_both_stores():
    ref, port = jstore.KubeStore(), NodeStore()
    pod = make_pod("p1")
    ref.create(to_ref(pod))
    port.create(pod)
    for s, get in ((ref, lambda o: o.metadata), (port, lambda o: o)):
        old = s.get("Pod", "p1", "default")
        s.patch_labels("Pod", "p1", "default", {"a": "b"})
        with pytest.raises((jstore.ConflictError, ConflictError)):
            s.update(old, check_version=True)
        fresh = s.get("Pod", "p1", "default")
        assert get(s.update(fresh, check_version=True)).resource_version == 3


def test_a_delete_carries_its_own_version_on_the_watch():
    s = NodeStore()
    q = s.watch(["Pod"])
    s.create(make_pod("p1"))
    gone = s.delete("Pod", "p1", "default")
    added, deleted = q.get(timeout=2), q.get(timeout=2)
    assert (added.type, deleted.type) == (ADDED, DELETED)
    assert deleted.object.resource_version == gone.resource_version > \
        added.object.resource_version
    assert deleted.revision == s.revision


def test_versions_are_strictly_monotonic_across_objects():
    s = NodeStore()
    seen = []
    for i in range(5):
        seen.append(s.create(make_pod(f"p{i}")).resource_version)
        s.delete("Pod", f"p{i}", "default")
        seen.append(s.version)
    assert seen == sorted(seen) and len(set(seen)) == len(seen)


def test_apply_event_keeps_recorded_versions_and_the_index():
    live = NodeStore()
    q = live.watch(["Pod"])
    live.create(make_pod("p1"))
    p = live.get("Pod", "p1", "default")
    p.labels["x"] = "y"
    live.update(p)
    live.create(make_pod("p2", node="n1"))
    live.delete("Pod", "p1", "default")
    events = [q.get(timeout=2) for _ in range(4)]
    replayed = make_store()
    for e in events:
        replayed.apply_event(e.type, e.object)
        replayed.apply_event(e.type, e.object)  # idempotent
    assert replayed.try_get("Pod", "p1", "default") is None
    assert replayed.get("Pod", "p2", "default").resource_version == \
        live.get("Pod", "p2", "default").resource_version
    assert replayed.version == max(e.object.resource_version for e in events)
    assert [o.name for o in replayed.list_by_index("Pod", "spec.nodeName", "n1")] == ["p2"]
    # the next write goes past the recorded history
    assert replayed.create(make_pod("p3")).resource_version == replayed.version


def test_the_index_matches_a_full_scan_after_mixed_writes_sorted_by_namespace():
    s = make_store()
    for i in range(8):
        s.create(make_pod(f"p{i}", node=f"n{i % 3}", ns=("b", "a")[i % 2]))
    s.patch_merge("Pod", "p1", "a", lambda p: setattr(p, "node", "n2"))
    s.patch_merge("Pod", "p2", "b", lambda p: setattr(p, "phase", "Running"))
    s.delete("Pod", "p4", "b")
    for node in ("n0", "n1", "n2"):
        scan = [(p.namespace, p.name) for p in s.list("Pod") if p.node == node]
        assert [(p.namespace, p.name) for p in s.list_by_index("Pod", "spec.nodeName", node)
                ] == scan
    assert [p.name for p in s.list_by_index("Pod", "status.phase", "Running")] == ["p2"]


def test_copy_false_keeps_identity_and_a_late_indexer_backfills():
    s = NodeStore()
    s.create(make_pod("p1", node="n1"))
    with pytest.raises(KeyError):
        s.list_by_index("Pod", "spec.nodeName", "n1")
    s.add_indexer("Pod", "spec.nodeName", lambda p: [p.node])
    a = s.list_by_index("Pod", "spec.nodeName", "n1", copy=False)
    b = s.list_by_index("Pod", "spec.nodeName", "n1", copy=False)
    assert a[0] is b[0] and a[0] is s.try_get("Pod", "p1", "default", copy=False)
    assert s.list_by_index("Pod", "spec.nodeName", "n1")[0] is not a[0]


def test_watch_replays_existing_then_streams_and_filters_kinds():
    s = NodeStore()
    s.create(make_pod("p1"))
    s.create(Node("n1"))
    q = s.watch(["Pod"])
    first = q.get(timeout=1)
    assert (first.type, first.object.name) == (ADDED, "p1") and q.empty()
    s.create(Node("n2"))
    s.patch_labels("Pod", "p1", "default", {"a": "b"})
    e = q.get(timeout=1)
    assert (e.type, e.kind, e.object.labels) == (MODIFIED, "Pod", {"a": "b"}) and q.empty()


def test_watchers_have_depth_gauges_and_stats():
    s = NodeStore()
    named = s.watch(["Pod"], name="ctrl-x")
    s.watch(["Pod", "Node"])
    s.watch()
    s.create(make_pod("p1"))
    stats = s.watch_stats()
    assert stats["ctrl-x"] == {"kinds": ["Pod"], "depth": 1}
    assert stats["Node|Pod"]["depth"] == 1 and stats["*"]["kinds"] == ["*"]
    assert metrics.WATCH_QUEUE_DEPTH.labels(kind_set="ctrl-x").value == 1
    s.stop_watch(named)
    assert "ctrl-x" not in s.watch_stats()
    assert metrics.WATCH_QUEUE_DEPTH.labels(kind_set="ctrl-x").value == 0


def test_events_carry_a_monotonic_enqueue_stamp_replays_too():
    s = NodeStore()
    s.create(make_pod("p0"))
    before = time.monotonic()
    q = s.watch(["Pod"])
    s.create(make_pod("p1"))
    replayed, live = q.get(timeout=1), q.get(timeout=1)
    assert before <= replayed.enqueued <= live.enqueued <= time.monotonic()
    assert WatchEvent(ADDED, make_pod("x")).enqueued == 0.0


def test_a_contended_lock_meters_its_wait_and_the_fast_path_nothing():
    s = NodeStore()
    contention = metrics.STORE_LOCK_CONTENTION.value
    s.create(make_pod("p1"))
    assert metrics.STORE_LOCK_CONTENTION.value == contention
    held, release = threading.Event(), threading.Event()

    def holder():
        with s._lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert held.wait(5)
        threading.Timer(0.05, release.set).start()
        wait = metrics.STORE_LOCK_WAIT.value
        s.create(make_pod("p2"))
        assert metrics.STORE_LOCK_CONTENTION.value == contention + 1
        assert metrics.STORE_LOCK_WAIT.value > wait
    finally:
        release.set()
        t.join(5)


def test_the_store_refuses_foreign_objects():
    with pytest.raises(TypeError):
        NodeStore().create(object())
