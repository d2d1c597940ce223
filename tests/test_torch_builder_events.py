"""The components' Kubernetes events against nos_tpu's: the scheduler's
``Scheduled`` and ``FailedScheduling``, the preemptor's ``Preempted``,
the quota controller's ``QuotaBorrowed`` and ``QuotaReclaimed`` and the
autoscaler's ``ColdStart``, ``ScaledUp``, ``ScaledDown`` and
``ScaledToZero``, plus the partitioner's ``CarveFailed`` and
``PartitioningApplied``.

Each case runs on both sides on translated clusters
(tests/torch_quota_cases.py, tests/torch_planner_cases.py,
tests/test_torch_autoscaler.py's ``Rigs``), each side with its own
``EventRecorder``, and the stored events must agree: reason, type, the
involved object (kind, namespace, name), the count (a repeat bumps it)
and the message, equal up to the H100 translation: resource names
(``translate_text``), a ModelServing's slice profile (2x4 ↔ 7g.80gb),
and a scale to zero's "chips held" ↔ "memory slices held" (the same
number: a 7g.80gb counts 8 memory slices, a 2x4 8 chips). The
reference's scheduler, preemptor and autoscaler count into a stub while
they run (``quiet_ref_metrics``): no process-wide series of the
reference is written.
"""
import pytest

from nos_tpu.controllers.autoscaler import controller as jautoscaler_mod
from nos_tpu.controllers.elasticquota import ElasticQuotaReconciler as JReconciler
from nos_tpu.kube.controller import Request
from nos_tpu.kube.events import EventRecorder as JEventRecorder
from nos_tpu.scheduler import preemption as jpreemption_mod
from nos_tpu.scheduler import scheduler as jscheduler_mod
from nos_tpu_torch.controllers.elasticquota import ElasticQuotaReconciler
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.store import NodeStore, Pod
from nos_tpu_torch.scheduler import Scheduler
from tests.test_torch_autoscaler import RECONCILER_CASES, Rigs
from tests.torch_planner_cases import TO_MIG, translate_text
from tests.torch_quota_cases import (
    CHIP_MEMORY_GB,
    GB,
    PlainNode,
    PodDesc,
    QuotaDesc,
    ref_scheduler,
    stores,
)


class _Series:
    def labels(self, **_):
        return self

    def inc(self, *_):
        pass

    def set(self, *_):
        pass

    def observe(self, *_):
        pass

    def remove(self, **_):
        pass


class _QuietMetrics:
    def __getattr__(self, name):
        return _Series()


@pytest.fixture
def quiet_ref_metrics(monkeypatch):
    for module in (jscheduler_mod, jpreemption_mod, jautoscaler_mod):
        monkeypatch.setattr(module, "metrics", _QuietMetrics())


def ref_events(jstore):
    return sorted((e.involved_kind, e.involved_namespace, e.involved_name, e.reason, e.type,
                   e.count, translate_text(e.message)) for e in jstore.list("Event"))


def port_events(tstore):
    return sorted((e.involved_kind, e.involved_namespace, e.involved_name, e.reason, e.type,
                   e.count, e.message) for e in tstore.list("Event"))


def chips(n):
    return {GB: 10 * n}


# ------------------------------------------------------------ the scheduler

def schedulers(jstore, tstore):
    jsched = ref_scheduler(jstore)
    jsched.recorder = jsched.capacity.recorder = JEventRecorder(jstore,
                                                                component="nos-scheduler")
    tsched = Scheduler(tstore, recorder=EventRecorder(tstore, component="nos-scheduler"))
    return jsched, tsched


def cycle(jsched, tsched, name, ns):
    """One cycle a side through its own writes (the reference's
    ``_decide`` and ``_apply_outcome``, the port's ``schedule_one``)."""
    jpod = jsched.store.get("Pod", name, ns)
    jsched._apply_outcome(jpod, jsched._decide(jpod))
    return tsched.schedule_one(tsched.store.get("Pod", name, ns))


def test_a_bind_records_scheduled(quiet_ref_metrics):
    jstore, tstore = stores(nodes=[PlainNode("n1", {**chips(8), "cpu": 64})],
                            pods=[PodDesc("p", chips(4), ns="team-a")])
    jsched, tsched = schedulers(jstore, tstore)
    assert cycle(jsched, tsched, "p", "team-a").decision == "bind"
    assert port_events(tstore) == ref_events(jstore) == [
        ("Pod", "team-a", "p", "Scheduled", "Normal", 1,
         "Successfully assigned team-a/p to n1")]


def test_every_failed_cycle_records_failed_scheduling_once_and_counts(quiet_ref_metrics):
    jstore, tstore = stores(nodes=[PlainNode("n1", {**chips(2), "cpu": 64}),
                                   PlainNode("n2", {"cpu": 64})],
                            pods=[PodDesc("big", chips(4))])
    jsched, tsched = schedulers(jstore, tstore)
    for _ in range(2):
        assert cycle(jsched, tsched, "big", "default").decision == "fail"
    got = port_events(tstore)
    assert got == ref_events(jstore)
    assert [(e[3], e[4], e[5]) for e in got] == [("FailedScheduling", "Warning", 2)]
    assert got[0][6].startswith("0/2 nodes are available")


def test_a_preemption_records_preempted_about_the_preemptor(quiet_ref_metrics):
    from nos_tpu_torch.api.v1alpha1 import CAPACITY_LABEL, CAPACITY_OVER_QUOTA

    over = {CAPACITY_LABEL: CAPACITY_OVER_QUOTA}
    jstore, tstore = stores(
        nodes=[PlainNode("n1", {**chips(8), "cpu": 64})],
        pods=[PodDesc("borrower", chips(8), ns="team-b", node="n1", phase="Running",
                      labels=over),
              PodDesc("p", chips(4), ns="team-a")],
        quotas=[QuotaDesc("team-a", min=chips(4), max=chips(8), name="qa"),
                QuotaDesc("team-b", min=chips(4), max=chips(8), name="qb")])
    jsched, tsched = schedulers(jstore, tstore)
    assert cycle(jsched, tsched, "p", "team-a").decision == "nominate"
    assert cycle(jsched, tsched, "p", "team-a").decision == "bind"
    got = port_events(tstore)
    assert got == ref_events(jstore)
    assert ("Pod", "team-a", "p", "Preempted", "Warning", 1,
            "Preempted 1 on n1 to fit team-a/p: team-b/borrower") in got
    assert [e[3] for e in got] == ["Preempted", "Scheduled"]


# ------------------------------------------------------------ the quotas

def test_quota_flips_record_borrowed_then_reclaimed():
    """team-a's min holds two of three 2-chip pods: the third borrows; the
    first gone, the third is back within quota. A first in-quota label is
    no news."""
    pods = [PodDesc(f"p{i}", chips(2), ns="team-a", node="n1", phase="Running",
                    created=100.0 + i) for i in range(3)]
    jstore, tstore = stores(nodes=[PlainNode("n1", {**chips(8), "cpu": 64})], pods=pods,
                            quotas=[QuotaDesc("team-a", min=chips(4), max=chips(8), name="qa")])
    jrec = JReconciler(jstore, chip_memory_gb=CHIP_MEMORY_GB,
                       recorder=JEventRecorder(jstore, component="nos-operator"))
    trec = ElasticQuotaReconciler(tstore, recorder=EventRecorder(tstore,
                                                                 component="nos-operator"))
    for step in range(2):
        if step:
            jstore.delete("Pod", "p0", "team-a")
            tstore.delete("Pod", "p0", "team-a")
        jrec.reconcile(Request(name="qa", namespace="team-a"))
        trec.reconcile("qa", "team-a")
    got = port_events(tstore)
    assert got == ref_events(jstore)
    assert [(e[2], e[3], e[4]) for e in got] == [
        ("p2", "QuotaBorrowed", "Warning"), ("p2", "QuotaReclaimed", "Normal")]
    assert got[0][6] == ("team-a/p2 running on capacity borrowed over ElasticQuota team-a/qa "
                         "min (preemptible)")


def test_a_quota_reconcile_writes_its_flight_record():
    from nos_tpu_torch.api.v1alpha1.elasticquota import ElasticQuota
    from nos_tpu_torch.record import FlightRecorder
    from nos_tpu_torch.timeline.sizes import SIZES

    store = NodeStore()
    store.create(ElasticQuota("qa", "team-a", {GB: 40}, {GB: 80}))
    for i in range(3):
        store.create(Pod(f"p{i}", "team-a", node="n1", phase="Running",
                         request={"nvidia.com/mig-2g.20gb": 1}, created=100.0 + i))
    flight = FlightRecorder()
    SIZES.unregister("record.flight_ring")
    revision = store.revision
    ElasticQuotaReconciler(store, flight_recorder=flight).reconcile("qa", "team-a")
    record = flight.records()[-1]
    assert record["kind"] == "quota.reconcile" and record["quota"] == "team-a/qa"
    assert record["revision"] == revision and record["used"] == {GB: 60}
    assert record["flips"] == [["team-a/p0", "in-quota"], ["team-a/p1", "in-quota"],
                               ["team-a/p2", "over-quota"]]


# ------------------------------------------------------------ the autoscaler

def _port_message(text: str) -> str:
    for tpu, gpu in TO_MIG.items():
        text = text.replace(f"({tpu} x", f"({gpu} x")
    return text.replace(" chips held in ", " memory slices held in ")


@pytest.mark.parametrize("case", sorted(RECONCILER_CASES))
def test_the_autoscalers_events_are_the_references(quiet_ref_metrics, case):
    rigs = Rigs()
    rigs.jrec.recorder = JEventRecorder(rigs.jstore, component="nos-autoscaler",
                                       clock=lambda: rigs.t)
    rigs.trec.recorder = EventRecorder(rigs.tstore, component="nos-autoscaler",
                                       clock=lambda: rigs.t)
    RECONCILER_CASES[case](rigs)
    want = sorted((k, ns, n, r, t, c, _port_message(m))
                  for k, ns, n, r, t, c, m in ref_events(rigs.jstore))
    got = port_events(rigs.tstore)
    assert got == want
    if case == "fleet_up_then_down":
        assert {e[3] for e in got} == {"ColdStart", "ScaledUp", "ScaledDown", "ScaledToZero"}


# ------------------------------------------------------------ the partitioner

def test_the_partitioner_records_carve_failed_once_a_reason_and_partitioning_applied():
    """Port only (the reference's partitioner runs TPU boards): a pod the
    plan serves on a re-carved node records PartitioningApplied; one no
    carve can serve CarveFailed, once while its reason holds."""
    from nos_tpu_torch.cluster import SimCluster

    cluster = SimCluster()
    cluster.add_mig_node("n1", gpus=1)
    cluster.mig.recorder = EventRecorder(cluster.store, component="nos-partitioner",
                                         clock=cluster.store.clock)
    cluster.store.create(Pod("fits", request={"nvidia.com/mig-3g.40gb": 1}))
    # three profiles one H100 cannot hold beside the 3g.40gb
    cluster.store.create(Pod("never", request={"nvidia.com/mig-4g.40gb": 1,
                                               "nvidia.com/mig-3g.40gb": 1,
                                               "nvidia.com/mig-1g.10gb": 1}))
    assert cluster.run_until_idle(100)
    events = cluster.store.list("Event")
    applied = [e for e in events if e.reason == "PartitioningApplied"]
    assert [(e.involved_name, e.message) for e in applied] == [
        ("fits", "re-partitioned 1 node(s) to serve default/fits")]
    failed = [e for e in events if e.reason == "CarveFailed"]
    reasons = [r["unserved"]["default/never"] for r in cluster.mig.plans]
    # one event a reason: the plans repeat the last one without a new event
    assert len(reasons) > len(set(reasons)) == len(failed) == 2
    assert all(e.involved_name == "never" and e.type == "Warning" and e.count == 1
               for e in failed)
    assert sorted(e.message for e in failed) == sorted(
        f"cannot carve slices for default/never: {r}" for r in set(reasons))
