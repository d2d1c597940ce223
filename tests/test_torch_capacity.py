"""CapacityScheduling (nos_tpu_torch.scheduler.plugins.capacity) against
nos_tpu's.

Exact, on translated cases (tests/torch_quota_cases.py): every test of
tests/scheduler/test_capacity.py, the quota math on both sides from one
description (the reference's chips counted as GB of
``nos.nebuly.com/gpu-memory``, a pod's chips asked for as MIG slices of
as many GB over ten), held to the reference's verdicts, messages and
``used`` (its ``tpu-chips`` dropped). Then the planner with the
simulation framework on both sides (the vanilla filters and the quota
PreFilter) on random quota clusters, and the port alone: a plain GPU's
80 GB, reservations forgotten when their pod is bound or gone, and the
infos memoized on the store's revision.
"""
import random
import time

import pytest

from nos_tpu.scheduler import framework as jfw
from nos_tpu.scheduler.framework import CycleState as JCycleState
from nos_tpu.scheduler.plugins.capacity import (
    CapacityScheduling as JCapacity,
    ElasticQuotaInfo as JInfo,
    ElasticQuotaInfos as JInfos,
    build_quota_infos as jbuild,
)
from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY, ElasticQuota
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import Planner
from nos_tpu_torch.scheduler import Scheduler
from nos_tpu_torch.scheduler import framework as tfw
from nos_tpu_torch.scheduler.framework import CycleState
from nos_tpu_torch.scheduler.plugins.capacity import (
    CapacityScheduling,
    ElasticQuotaInfo,
    ElasticQuotaInfos,
    build_quota_infos,
)
from tests.test_torch_planner import (
    NOW,
    RefPlanner,
    assert_plan_invariants,
    expected_unserved,
    placements,
    random_mig_case,
    snapshots,
)
from tests.torch_planner_cases import NodeDesc, port_state, ref_state, same_tables
from tests.torch_quota_cases import (
    CHIP_MEMORY_GB,
    GB,
    REF_GB,
    PodDesc,
    QuotaDesc,
    mig,
    port_pod,
    ref_pod,
    stores,
    to_port,
)

# a request of the reference's chips, as MIG slices of as many GB / 10
CHIPS = {1: {mig("1g.10gb"): 1}, 2: {mig("2g.20gb"): 1},
         3: {mig("1g.10gb"): 1, mig("2g.20gb"): 1}, 4: {mig("4g.40gb"): 1},
         8: {mig("7g.80gb"): 1}}


@pytest.fixture(autouse=True)
def tables():
    with same_tables() as geometries:
        yield geometries


def infos_both(*descs):
    """(reference infos, port infos) of (name, min, max, used) in GB."""
    jinfos, tinfos = [], []
    for name, min_, max_, used in descs:
        j = JInfo(name, {name}, {REF_GB: min_}, {REF_GB: max_} if max_ else None)
        t = ElasticQuotaInfo(name, {name}, {GB: min_}, {GB: max_} if max_ else None)
        j.used, t.used = {REF_GB: used}, {GB: used}
        jinfos.append(j)
        tinfos.append(t)
    return JInfos(jinfos), ElasticQuotaInfos(tinfos)


def both(jinfos, tinfos, method, *args):
    """The same question to both sides' infos, with GB named each side's way."""
    jargs = [{REF_GB: a[GB]} if isinstance(a, dict) else (REF_GB if a == GB else a)
             for a in args]
    want, got = getattr(jinfos, method)(*jargs), getattr(tinfos, method)(*args)
    assert got == want
    return got


# ------------------------------------------------------------ the infos

class TestElasticQuotaInfo:
    def test_used_over_min_with(self):
        jinfos, tinfos = infos_both(("a", 8, None, 6))
        j, t = jinfos.get("a"), tinfos.get("a")
        assert not t.used_over_min_with({GB: 2}) and not j.used_over_min_with({REF_GB: 2})
        assert t.used_over_min_with({GB: 3}) and j.used_over_min_with({REF_GB: 3})

    def test_used_over_max_with(self):
        jinfos, tinfos = infos_both(("a", 4, 8, 6))
        j, t = jinfos.get("a"), tinfos.get("a")
        assert not t.used_over_max_with({GB: 2}) and not j.used_over_max_with({REF_GB: 2})
        assert t.used_over_max_with({GB: 3}) and j.used_over_max_with({REF_GB: 3})

    def test_no_max_is_unlimited(self):
        jinfos, tinfos = infos_both(("a", 4, None, 100))
        assert not tinfos.get("a").used_over_max_with({GB: 100})
        assert not jinfos.get("a").used_over_max_with({REF_GB: 100})

    def test_add_remove_pod_idempotent(self):
        j, t = JInfo("a", {"a"}, {REF_GB: 8}, None), ElasticQuotaInfo("a", {"a"}, {GB: 8}, None)
        for info, key in ((j, REF_GB), (t, GB)):
            info.add_pod("ns/p", {key: 4})
            info.add_pod("ns/p", {key: 4})
            assert info.used == {key: 4}
            info.remove_pod("ns/p", {key: 4})
            info.remove_pod("ns/p", {key: 4})
            assert info.used == {key: 0}


class TestGuaranteedOverquota:
    def test_fair_share_math(self):
        jinfos, tinfos = infos_both(("a", 6, None, 6), ("b", 2, None, 0), ("c", 4, None, 1))
        # unused 0 + 2 + 3 = 5 of Σmin 12
        assert [both(jinfos, tinfos, "guaranteed_overquota", n, GB) for n in "abc"] == [2, 0, 1]

    def test_aggregated_used_over_min(self):
        jinfos, tinfos = infos_both(("a", 4, None, 4), ("b", 4, None, 3))
        assert not both(jinfos, tinfos, "aggregated_used_over_min_with", {GB: 1})
        assert both(jinfos, tinfos, "aggregated_used_over_min_with", {GB: 2})

    def test_within_guaranteed_with(self):
        jinfos, tinfos = infos_both(("a", 4, None, 2), ("b", 4, None, 0))
        assert both(jinfos, tinfos, "within_guaranteed_with", "a", {GB: 2})
        # past min, within min + floor(4/8 · unused 6)
        assert both(jinfos, tinfos, "within_guaranteed_with", "a", {GB: 5})
        assert not both(jinfos, tinfos, "within_guaranteed_with", "a", {GB: 6})


class TestBuildQuotaInfos:
    def test_ceq_shadows_eq(self):
        jstore, tstore = stores(quotas=[
            QuotaDesc("a", min={GB: 20}),
            QuotaDesc("default", min={GB: 80}, name="c", namespaces=["a", "b"])])
        jinfos, tinfos = jbuild(jstore, CHIP_MEMORY_GB), build_quota_infos(tstore)
        for ns in "ab":
            assert tinfos.for_namespace(ns).name == jinfos.for_namespace(ns).name == "ceq/c"

    def test_usage_from_bound_pods(self):
        jstore, tstore = stores(
            quotas=[QuotaDesc("a", min={GB: 80})],
            pods=[PodDesc("p", CHIPS[4], ns="a", node="n1", phase="Running"),
                  PodDesc("unbound", CHIPS[2], ns="a")])
        want = to_port(jbuild(jstore, CHIP_MEMORY_GB).for_namespace("a").used)
        assert build_quota_infos(tstore).for_namespace("a").used == want == {
            mig("4g.40gb"): 1, GB: 40}


# ------------------------------------------------------------ PreFilter

def pre_filter_both(jstore, tstore, pod: PodDesc, jplugin=None, tplugin=None):
    jplugin = jplugin or JCapacity(jstore, chip_memory_gb=CHIP_MEMORY_GB)
    tplugin = tplugin or CapacityScheduling(tstore)
    want = jplugin.pre_filter(JCycleState(), ref_pod(pod))
    got = tplugin.pre_filter(CycleState(), port_pod(pod))
    assert (got.code, got.message, got.plugin) == (want.code, want.message, want.plugin)
    return got


def running(name, chips, ns):
    return PodDesc(name, CHIPS[chips], ns=ns, node="n", phase="Running")


class TestPreFilter:
    def test_no_quota_passes(self):
        jstore, tstore = stores()
        assert pre_filter_both(jstore, tstore, PodDesc("p", CHIPS[4])).success

    def test_max_enforced(self):
        jstore, tstore = stores(quotas=[QuotaDesc("a", min={GB: 40}, max={GB: 80})],
                                pods=[running("running", 8, "a")])
        status = pre_filter_both(jstore, tstore, PodDesc("p", CHIPS[1], ns="a"))
        assert not status.success and status.message == "quota eq/a/quota: max exceeded"

    def test_borrowing_allowed_within_aggregate_min(self):
        jstore, tstore = stores(quotas=[QuotaDesc("a", min={GB: 40}, max={GB: 160}),
                                        QuotaDesc("b", min={GB: 80})],
                                pods=[running("running", 4, "a")])
        # past a's min (80 > 40), within Σmin 120
        assert pre_filter_both(jstore, tstore, PodDesc("p", CHIPS[4], ns="a")).success

    def test_borrowing_rejected_when_pool_exhausted(self):
        jstore, tstore = stores(quotas=[QuotaDesc("a", min={GB: 40}, max={GB: 160}),
                                        QuotaDesc("b", min={GB: 40})],
                                pods=[running("ra", 4, "a"), running("rb", 3, "b")])
        # 70 used + 20 > Σmin 80
        status = pre_filter_both(jstore, tstore, PodDesc("p", CHIPS[2], ns="a"))
        assert status.message == "quota eq/a/quota: cluster guaranteed pool exhausted"

    def test_reserve_counts_until_forgotten(self):
        jstore, tstore = stores(quotas=[QuotaDesc("a", min={GB: 40}, max={GB: 40})])
        jplugin = JCapacity(jstore, chip_memory_gb=CHIP_MEMORY_GB)
        tplugin = CapacityScheduling(tstore)
        pod, second = PodDesc("p", CHIPS[4], ns="a"), PodDesc("q", CHIPS[1], ns="a")
        assert pre_filter_both(jstore, tstore, pod, jplugin, tplugin).success
        jplugin.reserve(JCycleState(), ref_pod(pod), "n1")
        tplugin.reserve(CycleState(), port_pod(pod), "n1")
        # the reservation in flight takes the second pod past max
        assert not pre_filter_both(jstore, tstore, second, jplugin, tplugin).success
        jplugin.unreserve(JCycleState(), ref_pod(pod), "n1")
        tplugin.unreserve(CycleState(), port_pod(pod), "n1")
        assert pre_filter_both(jstore, tstore, second, jplugin, tplugin).success


# ------------------------------------------------------------ the planner

def quota_planner_case(rng, geometries):
    """A random MIG cluster (test_torch_planner's), its pending pods
    spread over two quota namespaces and one without a quota, and quotas
    tight enough that the PreFilter refuses some of them."""
    nodes, pods, case_ages = random_mig_case(rng, geometries)
    ages = {}
    for pod in pods:
        age = case_ages.get(pod.key)
        pod.ns = rng.choice(["a", "b", "free"])
        if age is not None:
            ages[pod.key] = age
    quotas = [QuotaDesc("a", min={GB: rng.choice([0, 10, 40])}, max={GB: rng.choice([40, 80])}),
              QuotaDesc("b", min={GB: rng.choice([20, 80])})]
    running = []
    for desc in nodes:
        for gpu, geometry in desc.used.items():
            for profile, qty in geometry.items():
                for k in range(qty):
                    running.append(PodDesc(f"run-{desc.name}-{gpu}-{profile}-{k}",
                                           {mig(profile): 1}, ns=rng.choice(["a", "b", "run"]),
                                           node=desc.name, phase="Running"))
    return nodes, pods, ages, quotas, running


@pytest.mark.parametrize("seed", range(12))
def test_plan_with_the_quota_prefilter_matches_the_reference(tables, monkeypatch, seed):
    """Both planners with the scheduler's filters and quota PreFilter over
    a store of the same quotas and bound pods: the same plan, placements
    and reasons, the quota refusing some pods a carve."""
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    nodes, pods, ages, quotas, running = quota_planner_case(random.Random(7000 + seed),
                                                            tables)
    jstore, tstore = stores(quotas=quotas, pods=running)
    jcap = JCapacity(jstore, chip_memory_gb=CHIP_MEMORY_GB)
    jframe = jfw.Framework(pre_filter_plugins=[jcap], filter_plugins=jfw.vanilla_filter_plugins())
    tframe = build_sim_framework(tstore)
    jsnap, tsnap = snapshots(nodes)
    jpods, tpods = [ref_pod(p) for p in pods], [port_pod(p) for p in pods]
    jplanner = RefPlanner(jframe)
    tplanner = Planner(tframe)
    jstate = jplanner.plan(jsnap, jpods, pending_ages=ages)
    tstate = tplanner.plan(tsnap, tpods, pending_ages=ages)
    assert port_state(tstate) == ref_state(jstate)
    assert placements(tsnap) == placements(jsnap)
    assert tplanner.last_unserved == expected_unserved(jplanner)
    assert tplanner.verdict_cache_stats() == jplanner.verdict_cache_stats()
    assert_plan_invariants(tplanner, tsnap, tpods, jplanner.passed)


def test_quota_prefilter_keeps_the_planner_from_placing(tables):
    """A pod past its quota's max is never placed in the plan: the
    vanilla filters alone place it."""
    _, tstore = stores(quotas=[QuotaDesc("a", min={GB: 10}, max={GB: 10})])
    pods = [PodDesc("big", {mig("4g.40gb"): 1}, ns="a"),
            PodDesc("ok", {mig("1g.10gb"): 1}, ns="a")]
    for framework, placed in ((build_sim_framework(tstore), ["ok"]),
                              (tfw.Framework(filter_plugins=tfw.vanilla_filter_plugins()),
                               ["big", "ok"])):
        _, tsnap = snapshots([NodeDesc("n1")])
        planner = Planner(framework)
        planner.plan(tsnap, [port_pod(p) for p in pods])
        assert placements(tsnap)["n1"] == placed
        assert ("a/big" in planner.last_unserved) == (placed == ["ok"])


# ------------------------------------------------------------ the port alone

def test_plain_gpu_request_counts_eighty_gb():
    store = NodeStore()
    store.create(ElasticQuota("quota", "a", min={RESOURCE_GPU_MEMORY: 160},
                              max={RESOURCE_GPU_MEMORY: 160}))
    store.create(Pod("one", "a", node="n", phase=PodPhase.RUNNING,
                     request={"nvidia.com/gpu": 1}))
    plugin = CapacityScheduling(store)
    assert build_quota_infos(store).for_namespace("a").used == {
        "nvidia.com/gpu": 1, RESOURCE_GPU_MEMORY: 80}
    assert plugin.pre_filter(CycleState(), Pod("two", "a", request={"nvidia.com/gpu": 1})).success
    status = plugin.pre_filter(CycleState(), Pod("three", "a", request={"nvidia.com/gpu": 2}))
    assert status.message == "quota eq/a/quota: max exceeded"
    # the knob: an H100 NVL's 94 GB
    assert not CapacityScheduling(store, gpu_memory_gb=94).pre_filter(
        CycleState(), Pod("two", "a", request={"nvidia.com/gpu": 1})).success


def test_reservation_of_a_deleted_pod_is_forgotten():
    store = NodeStore()
    store.create(ElasticQuota("quota", "a", min={RESOURCE_GPU_MEMORY: 40},
                              max={RESOURCE_GPU_MEMORY: 40}))
    sched = Scheduler(store)
    plugin = sched.capacity
    pod = store.create(Pod("p", "a", request={"nvidia.com/mig-4g.40gb": 1}))
    plugin.reserve(CycleState(), pod, "n1")  # reserved, then deleted before its bind
    store.delete("Pod", "p", "a")
    second = Pod("q", "a", request={"nvidia.com/mig-1g.10gb": 1})
    assert not plugin.pre_filter(CycleState(), second).success
    sched.step()
    assert plugin.reserved_keys() == set()
    assert plugin.pre_filter(CycleState(), second).success


def test_reservation_of_a_bound_pod_is_forgotten_once_listed():
    store = NodeStore()
    store.create(Node("n1", capacity={RESOURCE_GPU_MEMORY: 80},
                      allocatable={RESOURCE_GPU_MEMORY: 80}))
    store.create(ElasticQuota("quota", "a", min={RESOURCE_GPU_MEMORY: 80}))
    store.create(Pod("p", "a", request={RESOURCE_GPU_MEMORY: 40}))
    sched = Scheduler(store)
    assert sched.step() == 1 and sched.capacity.reserved_keys() == {"a/p"}
    # bound: the store counts it, once
    assert sched.capacity.snapshot().for_namespace("a").used == {RESOURCE_GPU_MEMORY: 40}
    sched.step()
    assert sched.capacity.reserved_keys() == set()
    assert sched.capacity.snapshot().for_namespace("a").used == {RESOURCE_GPU_MEMORY: 40}


def test_infos_are_built_once_per_store_revision():
    store = NodeStore()
    store.create(ElasticQuota("quota", "a", min={RESOURCE_GPU_MEMORY: 40}))
    plugin = CapacityScheduling(store)
    first = plugin.snapshot()
    assert plugin.snapshot() is first  # no write: the same infos
    store.create(Pod("p", "a", node="n", phase=PodPhase.RUNNING,
                     request={RESOURCE_GPU_MEMORY: 10}))
    second = plugin.snapshot()
    assert second is not first and second.for_namespace("a").used == {RESOURCE_GPU_MEMORY: 10}
    plugin.reserve(CycleState(), Pod("q", "a", request={RESOURCE_GPU_MEMORY: 20}), "n")
    folded = plugin.snapshot()
    assert folded.for_namespace("a").used == {RESOURCE_GPU_MEMORY: 30}
    assert second.for_namespace("a").used == {RESOURCE_GPU_MEMORY: 10}  # untouched


def test_external_usage_flips_a_verdict_at_one_store_revision():
    """``set_external_usage`` (``capacity.py:263-274``): a pool worker's
    replica holds only its pool's pods, so the parent charges each quota
    the usage outside it, folded in as one synthetic pod; the memoized
    infos are dropped, so the verdict reads it at the same revision."""
    store = NodeStore()
    store.create(ElasticQuota("quota", "a", min={RESOURCE_GPU_MEMORY: 80},
                              max={RESOURCE_GPU_MEMORY: 80}))
    plugin = CapacityScheduling(store)
    pod = Pod("p", "a", request={"nvidia.com/mig-4g.40gb": 1})
    revision = store.revision
    assert plugin.pre_filter(CycleState(), pod).success
    plugin.set_external_usage({"eq/a/quota": {RESOURCE_GPU_MEMORY: 60}})
    status = plugin.pre_filter(CycleState(), pod)
    assert not status.success and "max exceeded" in status.message
    assert plugin.snapshot().for_namespace("a").pods == {"__external__/eq/a/quota"}
    plugin.set_external_usage({"eq/a/quota": {}})
    assert plugin.pre_filter(CycleState(), pod).success
    assert store.revision == revision
