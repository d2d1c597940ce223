"""Node affinity, topology spread and inter-pod affinity (the framework's
NodeAffinityFit, PodTopologySpreadFit / Scoring and InterPodAffinityFit)
against nos_tpu's.

Exact, on translated cases (tests/torch_quota_cases.py): the scheduler
tests of tests/scheduler/test_scheduler.py's TestVanillaPredicates
(required node affinity and the five spread cases, the trial view that
overrides what is published among them), TestSoftScoring's two
ScheduleAnyway cases and TestInterPodAffinity's six, each a reconcile on
both sides held equal (decision, node, diagnosis, message, every pod's
state); then each filter's status and the spread score, plugin against
plugin, on random clusters of zoned nodes and labelled pods with random
terms, with the published view given and a trial view of the candidate
with pods removed; and the verdict cache's signature and bypass.
"""
import random

import pytest

from nos_tpu.partitioning.core import verdict_cache as jvc
from nos_tpu.scheduler import framework as jfw
from nos_tpu_torch.kube.store import (
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from nos_tpu_torch.partitioning.core import verdict_cache as tvc
from nos_tpu_torch.scheduler import framework as tfw
from tests.torch_planner_cases import same_tables
from tests.torch_quota_cases import (
    Both,
    PlainNode,
    PodDesc,
    port_plain_node,
    port_pod,
    ref_plain_node,
    ref_pod,
)

ZONE = "topology.kubernetes.io/zone"
WEB = {"app": "web"}


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


def zone_node(name, zone=None, cpu=8, **labels):
    if zone is not None:
        labels[ZONE] = zone
    return PlainNode(name, {"cpu": cpu}, labels=labels)


def running(name, node, labels=None, ns="default", cpu=1):
    return PodDesc(name, {"cpu": cpu}, ns=ns, node=node, phase="Running",
                   labels=dict(labels if labels is not None else WEB))


def spread(max_skew=1, when="DoNotSchedule", labels=None, key=ZONE):
    return TopologySpreadConstraint(topology_key=key, max_skew=max_skew,
                                    when_unsatisfiable=when,
                                    match_labels=dict(WEB if labels is None else labels))


def term(labels=None, key=ZONE, **kw):
    return PodAffinityTerm(topology_key=key, match_labels=dict(WEB if labels is None else labels),
                           **kw)


# ------------------------------------------------------------ TestVanillaPredicates

def test_required_node_affinity(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-gold", pool="gold"), zone_node("n-plain", cpu=64)])
    pod = PodDesc("p", {"cpu": 2}, node_affinity=[NodeSelectorTerm([
        NodeSelectorRequirement("pool", "In", ["gold"])])])
    assert both.sched(pod).node == "n-gold"


def _spread_pod(name):
    return PodDesc(name, {"cpu": 1}, labels=dict(WEB), spread=[spread()])


def test_topology_spread_prefers_empty_zone(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running(f"web-{i}", "n-a") for i in range(2)])
    assert both.sched(_spread_pod("web-new")).node == "n-b"


def test_topology_spread_unschedulable_when_all_zones_skewed(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b", cpu=1)],
                pods=[running("filler", "n-b", labels={})]
                + [running(f"web-{i}", "n-a") for i in range(2)])
    got = both.sched(_spread_pod("web-new"))
    assert got.decision == "fail"
    assert both.tstore.get("Pod", "web-new", "default").unschedulable


def test_topology_spread_trial_view_overrides_published():
    def infos(side_node, side_pod, side_info):
        published_a = side_info(side_node(zone_node("n-a", "zone-a")),
                                [side_pod(running(f"w{i}", "")) for i in (1, 2)])
        published_b = side_info(side_node(zone_node("n-b", "zone-b")), [])
        return published_a, published_b

    for fw, node, pod, info in ((jfw, ref_plain_node, ref_pod, jfw.NodeInfo),
                                (tfw, port_plain_node, port_pod, tfw.NodeInfo)):
        published_a, published_b = infos(node, pod, info)
        state = fw.CycleState()
        state[fw.TOPOLOGY_NODE_INFOS_KEY] = [published_a, published_b]
        incoming = pod(_spread_pod("web-new"))
        plugin = fw.PodTopologySpreadFit()
        assert not plugin.filter(state, incoming, published_a).success
        # the trial view of n-a with both victims evicted resolves the skew
        assert plugin.filter(state, incoming, info(published_a.node, [])).success


def test_topology_spread_nil_selector_is_noop(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running(f"other-{i}", "n-b", labels={}) for i in range(3)])
    pod = PodDesc("p", {"cpu": 1}, spread=[TopologySpreadConstraint(topology_key=ZONE)])
    assert both.sched(pod).node != ""


def test_topology_spread_requires_topology_label(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-bare"), zone_node("n-zoned", "zone-a")])
    assert both.sched(_spread_pod("web-new")).node == "n-zoned"


# ------------------------------------------------------------ TestSoftScoring

def test_schedule_anyway_spread_prefers_empty_zone_without_blocking(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running(f"web-{i}", "n-b") for i in range(2)])
    pod = PodDesc("web-new", {"cpu": 1}, labels=dict(WEB),
                  spread=[spread(when="ScheduleAnyway")])
    assert both.sched(pod).node == "n-a"


def test_schedule_anyway_never_blocks_single_zone(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a")],
                pods=[running(f"web-{i}", "n-a") for i in range(3)])
    pod = PodDesc("web-new", {"cpu": 1}, labels=dict(WEB),
                  spread=[spread(when="ScheduleAnyway")])
    assert both.sched(pod).node == "n-a"


# ------------------------------------------------------------ TestInterPodAffinity

def test_affinity_co_locates_with_matching_pod(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running("cache", "n-b", {"app": "cache"})])
    pod = PodDesc("worker", {"cpu": 1}, pod_affinity=[term({"app": "cache"})])
    assert both.sched(pod).node == "n-b"


def test_affinity_bootstrap_self_match(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a")])
    pod = PodDesc("first", {"cpu": 1}, labels={"app": "group"},
                  pod_affinity=[term({"app": "group"})])
    assert both.sched(pod).node == "n-a"


def test_anti_affinity_spreads_replicas(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running("web-0", "n-a")])
    pod = PodDesc("web-1", {"cpu": 1}, labels=dict(WEB), pod_anti_affinity=[term()])
    assert both.sched(pod).node == "n-b"


def test_existing_pods_anti_affinity_is_symmetric(monkeypatch):
    landlord = running("landlord", "n-a", {"app": "landlord"})
    landlord.pod_anti_affinity = [term()]
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[landlord])
    assert both.sched(PodDesc("web-new", {"cpu": 1}, labels=dict(WEB))).node == "n-b"


def test_match_expressions_terms_enforced(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a"), zone_node("n-b", "zone-b")],
                pods=[running("web-0", "n-a")])
    pod = PodDesc("web-1", {"cpu": 1}, labels=dict(WEB), pod_anti_affinity=[PodAffinityTerm(
        topology_key=ZONE, match_expressions=[NodeSelectorRequirement("app", "In", ["web"])])])
    assert both.sched(pod).node == "n-b"


def test_namespace_scoping_defaults_to_own_namespace(monkeypatch):
    both = Both(monkeypatch, [zone_node("n-a", "zone-a")],
                pods=[running("web-0", "n-a", ns="other")])
    pod = PodDesc("web-1", {"cpu": 1}, labels=dict(WEB), pod_anti_affinity=[term()])
    assert both.sched(pod).node == "n-a"


# ------------------------------------------------------------ random clusters

KEYS = (ZONE, "kubernetes.io/hostname", "rack")
APPS = ("web", "db", "cache")


def _random_labels(rng):
    return {"app": rng.choice(APPS)} if rng.random() < 0.8 else {}


def _random_term(rng):
    kw = {}
    if rng.random() < 0.3:
        kw["match_expressions"] = [NodeSelectorRequirement(
            "app", rng.choice(["In", "NotIn", "Exists", "DoesNotExist"]),
            rng.sample(APPS, rng.randint(1, 2)))]
    labels = {"app": rng.choice(APPS)} if rng.random() < 0.8 else {}
    if rng.random() < 0.2:
        kw["namespaces"] = rng.sample(["a", "b"], rng.randint(1, 2))
    return PodAffinityTerm(topology_key=rng.choice(KEYS), match_labels=labels, **kw)


def random_terms_case(rng):
    nodes = []
    for i in range(rng.randint(1, 6)):
        labels = {"kubernetes.io/hostname": f"n{i}"}
        if rng.random() < 0.85:
            labels[ZONE] = rng.choice(["z1", "z2", "z3"])
        if rng.random() < 0.5:
            labels["rack"] = rng.choice(["r1", "r2"])
        if rng.random() < 0.5:
            labels["pool"] = rng.choice(["gold", "plain"])
        nodes.append(PlainNode(f"n{i}", {"cpu": 16}, labels=labels))
    pods = []
    for j in range(rng.randint(0, 12)):
        pod = running(f"r{j}", rng.choice(nodes).name, _random_labels(rng),
                      ns=rng.choice(["a", "b"]))
        if rng.random() < 0.2:
            pod.pod_anti_affinity = [_random_term(rng)]
        pods.append(pod)
    pod = PodDesc("p", {"cpu": 1}, ns=rng.choice(["a", "b"]), labels=_random_labels(rng))
    if rng.random() < 0.4:
        pod.spread = [TopologySpreadConstraint(
            topology_key=rng.choice(KEYS), max_skew=rng.choice([1, 1, 2]),
            when_unsatisfiable=rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
            match_labels={"app": rng.choice(APPS)} if rng.random() < 0.85 else {})
            for _ in range(rng.randint(1, 2))]
    if rng.random() < 0.4:
        pod.pod_affinity = [_random_term(rng) for _ in range(rng.randint(1, 2))]
    if rng.random() < 0.4:
        pod.pod_anti_affinity = [_random_term(rng)]
    if rng.random() < 0.3:
        pod.node_affinity = [NodeSelectorTerm([NodeSelectorRequirement(
            rng.choice(["pool", "rack", ZONE]), rng.choice(["In", "NotIn", "Exists",
                                                             "DoesNotExist"]),
            [rng.choice(["gold", "plain", "r1", "z1"])])]) for _ in range(rng.randint(1, 2))]
    return nodes, pods, pod


FILTERS = [(jfw.NodeAffinityFit, tfw.NodeAffinityFit),
           (jfw.PodTopologySpreadFit, tfw.PodTopologySpreadFit),
           (jfw.InterPodAffinityFit, tfw.InterPodAffinityFit)]


@pytest.mark.parametrize("seed", range(40))
def test_filters_and_spread_score_match_the_reference(seed):
    rng = random.Random(9500 + seed)
    nodes, pods, pod = random_terms_case(rng)
    jinfos, tinfos = [], []
    for desc in nodes:
        on = [p for p in pods if p.node == desc.name]
        jinfos.append(jfw.NodeInfo(node=ref_plain_node(desc), pods=[ref_pod(p) for p in on]))
        tinfos.append(tfw.NodeInfo(node=port_plain_node(desc), pods=[port_pod(p) for p in on]))
    jpod, tpod = ref_pod(pod), port_pod(pod)
    jstate, tstate = jfw.CycleState(), tfw.CycleState()
    jstate[jfw.TOPOLOGY_NODE_INFOS_KEY] = jinfos
    tstate[tfw.TOPOLOGY_NODE_INFOS_KEY] = tinfos
    for jinfo, tinfo in zip(jinfos, tinfos):
        # the published view, then a trial view with some pods removed
        keep = [rng.random() < 0.5 for _ in jinfo.pods]
        views = [(jinfo, tinfo),
                 (jfw.NodeInfo(jinfo.node, [p for p, k in zip(jinfo.pods, keep) if k]),
                  tfw.NodeInfo(tinfo.node, [p for p, k in zip(tinfo.pods, keep) if k]))]
        for jview, tview in views:
            for jcls, tcls in FILTERS:
                assert tcls.name == jcls.name
                want = jcls().filter(jstate, jpod, jview)
                got = tcls().filter(tstate, tpod, tview)
                assert (got.code, got.message) == (want.code, want.message), tcls.name
        assert (tfw.PodTopologySpreadScoring().score(tstate, tpod, tinfo)
                == jfw.PodTopologySpreadScoring().score(jstate, jpod, jinfo))


@pytest.mark.parametrize("seed", range(20))
def test_cycle_with_terms_matches_the_reference(monkeypatch, seed):
    nodes, pods, pod = random_terms_case(random.Random(9700 + seed))
    both = Both(monkeypatch, nodes, pods=pods)
    both.sched(pod)


def test_the_seven_vanilla_filters_in_the_reference_order():
    assert [p.name for p in tfw.vanilla_filter_plugins()] == [
        p.name for p in jfw.vanilla_filter_plugins()]
    assert all(tfw.is_verdict_cacheable(p) for p in tfw.vanilla_filter_plugins())


# ------------------------------------------------------------ the verdict cache

def test_signature_covers_required_node_affinity():
    base = PodDesc("p", {"cpu": 1})
    gold = PodDesc("p", {"cpu": 1}, node_affinity=[NodeSelectorTerm([
        NodeSelectorRequirement("pool", "In", ["gold"])])])
    plain = PodDesc("p", {"cpu": 1}, node_affinity=[NodeSelectorTerm([
        NodeSelectorRequirement("pool", "In", ["plain"])])])
    signatures = {tvc.pod_signature(port_pod(d)) for d in (base, gold, plain)}
    assert len(signatures) == 3
    assert len({jvc.pod_signature(ref_pod(d)) for d in (base, gold, plain)}) == 3


@pytest.mark.parametrize("field,value", [("spread", [spread()]), ("pod_affinity", [term()]),
                                         ("pod_anti_affinity", [term()]), ("labels", WEB)])
def test_needs_cluster_context_matches_the_reference(field, value):
    desc = PodDesc("p", {"cpu": 1}, **{field: value})
    assert tvc.needs_cluster_context(port_pod(desc)) == jvc.needs_cluster_context(ref_pod(desc))
