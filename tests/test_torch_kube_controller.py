"""The controller runtime (nos_tpu_torch.kube.controller) against
nos_tpu.kube.controller.

- ``_WorkQueue``: one seeded sequence of adds, delayed adds, gets, dones
  and clock advances on the reference's queue (its ``time`` pointed at a
  fake clock) and the port's (given the same clock) hands out the same
  requests at the same points: dedup, a re-add while processing running
  again after ``done``, delays coming due.
- ``Controller``: the same store writes and the same scripted results
  (``Result()``, ``requeue``, ``requeue_after``, a raise) reconcile the
  same requests in the same order on both sides; the reference's worker
  step is run in the test thread, the port's through ``drain``.
- The port's threaded path (``Manager.start`` / ``wait_idle``) and its
  drain give the same reconcile counts; ``Manager.drain`` runs a chain of
  controllers whose reconciles write for each other to the end.
- The reference's controller cases (tests/kube/test_store.py): a watch
  drives a reconcile, a predicate filters, ``requeue_after`` repeats; and
  a started controller registers its loop stats.
"""
import random
import time as real_time

import pytest

from nos_tpu.kube import controller as jctl
from nos_tpu.kube import objects as jobj
from nos_tpu.kube.store import KubeStore
from nos_tpu_torch.kube import controller as tctl
from nos_tpu_torch.kube.controller import Controller, Manager, Request, Result, Watch
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.store import MODIFIED, NodeStore
from nos_tpu_torch.util.loop_health import LOOPS
from tests.torch_kube_cases import to_ref


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class FakeTime:
    """The reference controller module's ``time``, on a test clock."""

    def __init__(self, clock):
        self.monotonic = clock
        self.sleep = real_time.sleep


@pytest.mark.parametrize("seed", range(8))
def test_work_queues_hand_out_the_same_requests(monkeypatch, seed):
    clock = Clock()
    monkeypatch.setattr(jctl, "time", FakeTime(clock))
    rng = random.Random(seed)
    ref, port = jctl._WorkQueue(), tctl._WorkQueue(clock)
    reqs = [f"r{i}" for i in range(4)]
    processing = []
    trace = []
    for _ in range(120):
        op = rng.random()
        name = rng.choice(reqs)
        if op < 0.3:
            ref.add(jctl.Request(name))
            port.add(Request(name))
        elif op < 0.45:
            delay = rng.choice([0.0, 0.1, 0.5])
            ref.add_after(jctl.Request(name), delay)
            port.add_after(Request(name), delay)
        elif op < 0.7:
            got = (ref.get(timeout=0), port.get(timeout=0))
            trace.append(tuple(g and g.name for g in got))
            if got[0] is not None:
                processing.append(got[0].name)
        elif op < 0.9 and processing:
            done = processing.pop(rng.randrange(len(processing)))
            ref.done(jctl.Request(done))
            port.done(Request(done))
        else:
            clock.t += rng.choice([0.05, 0.2, 1.0])
        assert ref.idle() == port.idle()
    assert [p for _, p in trace] == [r for r, _ in trace]
    assert any(r for r, _ in trace) and any(r is None for r, _ in trace)


def _script(seed):
    """name → the results of its successive reconciles."""
    rng = random.Random(seed)
    choices = [None, "requeue", "after", "raise"]
    return {f"p{i}": [rng.choice(choices) for _ in range(3)] for i in range(5)}


def _reconciler(script, seen, result_type):
    def reconcile(req):
        n = sum(1 for s in seen if s == req.name)
        seen.append(req.name)
        steps = script.get(req.name, [])
        what = steps[n] if n < len(steps) else None
        if what == "raise":
            raise RuntimeError("scripted")
        if what == "requeue":
            return result_type(requeue=True)
        if what == "after":
            return result_type(requeue_after=0.1)
        return None
    return reconcile


def _ref_drain(c):
    """The reference's pump and worker bodies, run in this thread until
    nothing is due."""
    while True:
        while not c._event_queue.empty():
            c._dispatch(c._event_queue.get_nowait())
        req = c.queue.get(timeout=0)
        if req is None:
            return
        try:
            result = c.reconciler(req)
        except Exception:
            result = jctl.Result(requeue=True, requeue_after=0.05)
        finally:
            c.queue.done(req)
        if result and result.requeue_after > 0:
            c.queue.add_after(req, result.requeue_after)
        elif result and result.requeue:
            c.queue.add(req)


def _writes(rng):
    ops = []
    for _ in range(25):
        name = f"p{rng.randrange(5)}"
        ops.append((rng.choice(["create", "label", "delete"]), name, rng.choice(["a", "b"])))
    return ops


def _apply(ops, ref, port):
    for op, name, value in ops:
        for s in (ref, port):
            try:
                if op == "create":
                    pod = Pod(name, labels={"v": value})
                    s.create(to_ref(pod) if s is ref else pod)
                elif op == "label":
                    s.patch_labels("Pod", name, "default", {"v": value})
                else:
                    s.delete("Pod", name, "default")
            except (KeyError, ValueError):
                pass


@pytest.mark.parametrize("seed", range(6))
def test_controllers_reconcile_the_same_requests_in_the_same_order(monkeypatch, seed):
    clock = Clock()
    monkeypatch.setattr(jctl, "time", FakeTime(clock))
    monkeypatch.setattr(jctl.log, "exception", lambda *a, **k: None)
    monkeypatch.setattr(tctl.log, "exception", lambda *a, **k: None)
    script = _script(seed)
    ref, port = KubeStore(), NodeStore()
    jseen, tseen = [], []
    predicate = (lambda e: e.type != "DELETED")
    jc = jctl.Controller("x", ref, _reconciler(script, jseen, jctl.Result),
                         [jctl.Watch("Pod", predicate=predicate)])
    tc = Controller("x", port, _reconciler(script, tseen, Result),
                    [Watch("Pod", predicate=predicate)], clock=clock)
    jc._event_queue = ref.watch({"Pod"}, name="x")
    tc.subscribe()
    rng = random.Random(seed)
    for _ in range(4):
        _apply(_writes(rng), ref, port)
        _ref_drain(jc)
        tc.drain()
        assert tseen == jseen
        clock.t += 0.12
    assert tseen == jseen and len(jseen) > 5


@pytest.mark.parametrize("seed", range(3))
def test_the_threaded_path_and_the_drain_reconcile_the_same_counts(seed):
    rng = random.Random(seed)
    ops = _writes(rng)
    counts = []
    for threaded in (True, False):
        store = NodeStore()
        seen = []
        c = Controller("t", store, _reconciler({}, seen, Result), [Watch("Pod")])
        mgr = Manager(store, [c])
        if threaded:
            mgr.start()
        try:
            for op, name, value in ops:
                try:
                    if op == "create":
                        store.create(Pod(name, labels={"v": value}))
                    elif op == "label":
                        store.patch_labels("Pod", name, "default", {"v": value})
                    else:
                        store.delete("Pod", name, "default")
                except (KeyError, ValueError):
                    pass
                if threaded:
                    assert mgr.wait_idle(timeout=5, settle=0.0)
                else:
                    mgr.drain()
        finally:
            if threaded:
                mgr.stop()
        counts.append(sorted((n, seen.count(n)) for n in set(seen)))
    assert counts[0] == counts[1] and counts[0]


def test_a_drain_runs_a_chain_of_controllers_to_its_end():
    store = NodeStore()
    mgr = Manager(store)

    def copy_to(ns_to):
        def reconcile(req):
            if store.try_get("Pod", req.name, ns_to) is None:
                store.create(Pod(req.name, ns_to))
        return reconcile

    mgr.add(Controller("a", store, copy_to("b"),
                       [Watch("Pod", predicate=lambda e: e.object.namespace == "a")]))
    mgr.add(Controller("b", store, copy_to("c"),
                       [Watch("Pod", predicate=lambda e: e.object.namespace == "b")]))
    store.create(Pod("x", "a"))
    assert mgr.drain() == 2  # a copies x into b, then b copies it into c
    assert [p.namespace for p in store.list("Pod")] == ["a", "b", "c"]
    assert mgr.drain() == 0


def test_requeue_after_comes_due_on_the_controllers_clock():
    clock = Clock()
    store = NodeStore()
    calls = []
    c = Controller("late", store, lambda req: calls.append(req.name) or Result(requeue_after=1.0),
                   [Watch("Pod")], clock=clock)
    store.create(Pod("p"))
    assert c.drain() == 1
    assert c.drain() == 0  # not due yet
    clock.t += 1.0
    assert c.drain() == 1 and calls == ["p", "p"]


def test_a_watch_drives_a_reconcile_and_a_predicate_filters():
    s = NodeStore()
    seen = []
    c = Controller("test", s, lambda req: seen.append(req.name),
                   [Watch("Pod", predicate=lambda e: e.type == MODIFIED)])
    mgr = Manager(s, [c])
    mgr.start()
    try:
        s.create(Pod("p1"))
        assert mgr.wait_idle(timeout=5)
        assert seen == []
        assert "test" in LOOPS.names()
        s.patch_merge("Pod", "p1", "default", lambda p: setattr(p, "phase", "Running"))
        assert mgr.wait_idle(timeout=5)
        assert seen == ["p1"]
    finally:
        mgr.stop()
    assert "test" not in LOOPS.names()


def test_requeue_after_repeats_on_the_threaded_path():
    s = NodeStore()
    calls = []

    def reconcile(req):
        calls.append(req.name)
        return Result(requeue_after=0.01) if len(calls) < 3 else Result()

    c = Controller("test", s, reconcile, [Watch("Pod")])
    c.start()
    try:
        s.create(Pod("p1"))
        deadline = real_time.monotonic() + 5
        while len(calls) < 3 and real_time.monotonic() < deadline:
            real_time.sleep(0.01)
        assert len(calls) >= 3
    finally:
        c.stop()


def test_reference_requests_map_to_the_same_keys():
    assert Request("a", "b").namespaced_name == jctl.Request("a", "b").namespaced_name
    assert Request("a").namespaced_name == jctl.Request("a").namespaced_name == "a"
    pod = jobj.Pod(metadata=jobj.ObjectMeta(name="n", namespace="s"))
    ref_req = jctl.default_mapper(jctl.WatchEvent("ADDED", pod))[0]
    port_req = tctl.default_mapper(tctl.WatchEvent("ADDED", Pod("n", "s")))[0]
    assert (port_req.name, port_req.namespace) == (ref_req.name, ref_req.namespace)
