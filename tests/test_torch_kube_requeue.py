"""The work queue's delayed re-adds (nos_tpu_torch.kube.controller).

The port's queue keeps one delayed re-add a request, the soonest, as
client-go's delaying queue does; the reference's queue
(nos_tpu/kube/controller.py:88-104) keeps every one. The difference
shows only where a request is handed out on its first re-add, done, and
then comes due again on a later one: the reference hands it out twice,
the port once. A reconcile that requeues itself on a period and is also
woken by events (an agent's reporter) otherwise gains a re-add an event.

- Two pending re-adds of one request, in either order: one hand-out, at
  the sooner; none at the later.
- The same sequence on the reference's queue hands the request out
  twice (the deliberate difference).
- A re-add asked for after the last one came due is kept.
- A controller whose reconcile requeues after 1 s, woken by five events
  0.1 s apart, reconciles once a period, not once an event.
"""
import time as real_time

import pytest

from nos_tpu.kube import controller as jctl
from nos_tpu_torch.kube.controller import Controller, Request, Result, Watch, _WorkQueue
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.store import NodeStore


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


def _hand_outs(queue, clock, request_type, delays):
    """Ask the delays for one request, then step the clock past each
    delay in turn, taking and finishing what comes due: the times (from
    the start) at which it was handed out."""
    start = clock.t
    for delay in delays:
        queue.add_after(request_type("r"), delay)
    out = []
    for step in sorted(delays):
        clock.t = start + step
        got = queue.get(timeout=0)
        if got is not None:
            out.append(step)
            queue.done(got)
    clock.t = start + max(delays) + 1.0
    assert queue.get(timeout=0) is None
    return out


@pytest.mark.parametrize("delays", [(0.5, 0.1), (0.1, 0.5)], ids=["later-first", "sooner-first"])
def test_a_request_keeps_its_soonest_delayed_re_add(delays):
    clock = Clock()
    assert _hand_outs(_WorkQueue(clock), clock, Request, delays) == [0.1]


@pytest.mark.parametrize("delays", [(0.5, 0.1), (0.1, 0.5)], ids=["later-first", "sooner-first"])
def test_the_reference_hands_out_each_delayed_re_add(monkeypatch, delays):
    clock = Clock()
    monkeypatch.setattr(jctl, "time", FakeTime(clock))
    assert _hand_outs(jctl._WorkQueue(), clock, jctl.Request, delays) == [0.1, 0.5]


def test_a_re_add_after_the_last_came_due_is_kept():
    clock = Clock()
    queue = _WorkQueue(clock)
    queue.add_after(Request("r"), 0.1)
    clock.t += 0.1
    got = queue.get(timeout=0)
    assert got == Request("r")
    queue.add_after(Request("r"), 0.5)  # while processing
    queue.done(got)
    assert queue.get(timeout=0) is None
    clock.t += 0.5
    got = queue.get(timeout=0)
    assert got == Request("r")
    queue.done(got)
    queue.add_after(Request("r"), 0.2)  # after
    clock.t += 0.2
    assert queue.get(timeout=0) == Request("r")


def test_a_periodic_reconcile_woken_by_events_runs_once_a_period():
    clock = Clock()
    store = NodeStore()
    seen = []

    def reconcile(req):
        seen.append(clock.t)
        return Result(requeue_after=1.0)

    c = Controller("periodic", store, reconcile, [Watch("Pod")], clock=clock)
    store.create(Pod("p"))
    assert c.drain() == 1
    for i in range(5):
        clock.t += 0.1
        store.patch_merge("Pod", "p", "default",
                          lambda p, i=i: p.annotations.update(n=str(i)))
        assert c.drain() == 1
    start = seen[0]
    ran = 0
    for k in range(6):  # through the times every reconcile asked for
        clock.t = start + 1.0 + 0.1 * k
        ran += c.drain()
    assert ran == 1  # the soonest alone, 1 s after the first reconcile
    clock.t = start + 1.9
    assert c.drain() == 0
    clock.t = start + 2.0
    assert c.drain() == 1  # the period goes on
    assert len(seen) == 8
