"""Preemption (nos_tpu_torch.scheduler.preemption) and the scheduler's
PostFilter against nos_tpu's, and the quota loop in SimCluster.

Exact, on translated cases (tests/torch_quota_cases.py; the reference
counting 10 GB a chip, driven through ``Scheduler._decide`` and its own
writes with CapacityScheduling and the vanilla filters): the single-pod
cases of tests/scheduler/test_preemption.py (a borrower past its share,
the four PodDisruptionBudget cases) and of tests/scheduler/test_scheduler.py
(over-quota, in-quota, same-namespace, lower-priority, a quota-only
preemption on a roomy node), on nodes that advertise
``nos.nebuly.com/gpu-memory`` where the reference's advertise chips;
then 40 random clusters of MIG and MPS nodes with 2-4 quota namespaces
(one pair sometimes under a composite quota), running pods labelled by
both quota controllers, budgets, and one pending preemptor. Each is held
to the reference's decision, nominated node, victims, diagnosis,
messages, and every pod's node, nomination and label, before and after
the controllers run again. Running pods of MIG and MPS nodes are created
at distinct instants, the accounting order's one tolerated difference
lying in their ties (ROADMAP.md). Last, the port alone: SimCluster
closing the quota loop (borrowing, reclaim by preemption, the freed
slices re-carved) and holding its quota invariants.
"""
import random

import pytest

from nos_tpu.controllers.elasticquota import (
    CompositeElasticQuotaReconciler as JCompositeReconciler,
    ElasticQuotaReconciler as JReconciler,
)
from nos_tpu.kube.controller import Request
from nos_tpu_torch.api.v1alpha1 import CAPACITY_IN_QUOTA, CAPACITY_LABEL, CAPACITY_OVER_QUOTA
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.elasticquota import ElasticQuotaController
from nos_tpu_torch.kube.store import (
    Pod,
    PodAffinityTerm,
    PodPhase,
    TopologySpreadConstraint,
)
from nos_tpu_torch.scheduler import Scheduler
from tests.torch_planner_cases import MIG_PROFILES, NodeDesc, same_tables
from tests.torch_quota_cases import (
    CHIP_MEMORY_GB,
    GB,
    PdbDesc,
    PlainNode,
    PodDesc,
    QuotaDesc,
    assert_same_outcome,
    cycle_both,
    mig,
    mps,
    pod_view,
    ref_scheduler,
    reservations,
    stores,
    to_port,
)

OVER = {CAPACITY_LABEL: CAPACITY_OVER_QUOTA}


@pytest.fixture
def tables():
    with same_tables() as geometries:
        yield geometries


def chips(n):
    """The reference's n chips, in GB of the aggregate."""
    return {GB: 10 * n}


def node(name, n_chips):
    return PlainNode(name, {**chips(n_chips), "cpu": 64})


def running(name, n_chips, ns, node_name="n1", labels=None, priority=0):
    return PodDesc(name, chips(n_chips), ns=ns, node=node_name, phase="Running",
                   labels=dict(labels or {}), priority=priority)


def over_quota(name, n_chips, ns, node_name, gang=None, size=2, **labels):
    """A running over-quota pod, a member of ``gang`` when given."""
    labels.update(OVER)
    if gang:
        labels.update({"nos.nebuly.com/gang": gang, "nos.nebuly.com/gang-size": str(size)})
    return running(name, n_chips, ns, node_name, labels)


def quota(ns, min_chips=4, max_chips=16, name="q"):
    return QuotaDesc(ns, min=chips(min_chips), max=chips(max_chips), name=name)


def cycle(jstore, tstore, name, ns, scheds=None):
    """One cycle of ``ns/name`` on both sides, held equal; the port's
    outcome."""
    jsched, tsched = scheds or (ref_scheduler(jstore), Scheduler(tstore))
    want, got = cycle_both(jstore, tstore, name, ns, jsched, tsched)
    assert_same_outcome(want, got)
    want_pods, got_pods = pod_view(jstore, tstore)
    assert got_pods == want_pods
    want_held, got_held = reservations(jstore, tstore)
    assert got_held == want_held
    return got


# ------------------------------------------------------------ test_scheduler.py

class TestPreemptionFlow:
    def cluster(self, pods):
        return stores(nodes=[node("n1", 8)], pods=pods,
                      quotas=[quota("team-a", 4, 8, "qa"), quota("team-b", 4, 8, "qb")])

    def test_over_quota_pod_preempted_by_guaranteed_claim(self):
        jstore, tstore = self.cluster([running("borrower", 8, "team-b", labels=OVER),
                                       PodDesc("p", chips(4), ns="team-a")])
        scheds = (ref_scheduler(jstore), Scheduler(tstore))
        got = cycle(jstore, tstore, "p", "team-a", scheds)
        assert (got.decision, got.node, got.victims) == ("nominate", "n1", ["team-b/borrower"])
        assert tstore.get("Pod", "p", "team-a").nominated_node == "n1"
        # the next cycle binds
        got = cycle(jstore, tstore, "p", "team-a", scheds)
        assert got.decision == "bind" and tstore.get("Pod", "p", "team-a").node == "n1"
        assert tstore.get("Pod", "p", "team-a").nominated_node == ""

    def test_in_quota_pod_not_preempted(self):
        jstore, tstore = self.cluster([
            running("holder", 8, "team-b", labels={CAPACITY_LABEL: CAPACITY_IN_QUOTA}),
            PodDesc("p", chips(4), ns="team-a")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.decision == "fail" and tstore.try_get("Pod", "holder", "team-b")

    def test_same_namespace_priority_preemption(self):
        jstore, tstore = self.cluster([running("low", 8, "team-a"),
                                       PodDesc("vip", chips(8), ns="team-a", priority=100)])
        got = cycle(jstore, tstore, "vip", "team-a")
        assert got.victims == ["team-a/low"] and tstore.try_get("Pod", "low", "team-a") is None

    def test_lower_priority_preemptor_cannot_evict(self):
        jstore, tstore = self.cluster([running("high", 8, "team-a", priority=100),
                                       PodDesc("p", chips(8), ns="team-a")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.decision == "fail" and tstore.try_get("Pod", "high", "team-a")

    def test_quota_only_preemption_on_roomy_node(self):
        """The node has room; only the quota blocks the pod, and the
        over-quota borrower is still evicted (quota-aware reprieve)."""
        jstore, tstore = stores(
            nodes=[node("n1", 16)],
            quotas=[quota("team-a", 4, 16, "q-team-a"), quota("team-b", 4, 16, "q-team-b")],
            pods=[running("borrower", 8, "team-b", labels=OVER),
                  PodDesc("p", chips(6), ns="team-a")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert (got.decision, got.victims) == ("nominate", ["team-b/borrower"])


# ------------------------------------------------------------ test_preemption.py

def test_borrower_cannot_evict_beyond_guaranteed_share():
    """min 4 + fair share 2 < 8: team-a is not entitled to reclaim."""
    jstore, tstore = stores(nodes=[node("n1", 8)],
                            quotas=[quota("team-a"), quota("team-b")],
                            pods=[running("borrower", 8, "team-b", labels=OVER),
                                  PodDesc("p", chips(8), ns="team-a")])
    got = cycle(jstore, tstore, "p", "team-a")
    assert got.decision == "fail" and tstore.try_get("Pod", "borrower", "team-b")


class TestPdbAwarePreemption:
    def cluster(self, pods, pdbs, nodes=("n1", "n2")):
        # team-a's min covers the preemptor: admission takes the
        # guaranteed path and only the budgets differ
        return stores(nodes=[node(n, 8) for n in nodes], pods=pods, pdbs=pdbs,
                      quotas=[quota("team-a", min_chips=8), quota("team-b")])

    @staticmethod
    def svc(name, n_chips, node_name):
        return running(name, n_chips, "team-b", node_name, labels={**OVER, "app": "svc"})

    def test_prefers_node_without_pdb_violation(self):
        jstore, tstore = self.cluster(
            [self.svc("protected", 8, "n1"), running("plain", 8, "team-b", "n2", OVER),
             PodDesc("p", chips(8), ns="team-a")],
            [PdbDesc("pdb", "team-b", {"app": "svc"}, min_available=1)])
        got = cycle(jstore, tstore, "p", "team-a")
        assert (got.node, got.victims) == ("n2", ["team-b/plain"])

    def test_pdb_violation_still_allowed_as_last_resort(self):
        jstore, tstore = self.cluster(
            [self.svc("protected", 8, "n1"), PodDesc("p", chips(8), ns="team-a")],
            [PdbDesc("pdb", "team-b", {"app": "svc"}, min_available=1)], nodes=("n1",))
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.victims == ["team-b/protected"]

    def test_cumulative_pdb_budget_counts_second_eviction_as_violation(self):
        jstore, tstore = self.cluster(
            [self.svc("svc-0", 4, "n1"), self.svc("svc-1", 4, "n1"),
             running("plain-0", 4, "team-b", "n2", OVER),
             running("plain-1", 4, "team-b", "n2", OVER), PodDesc("p", chips(8), ns="team-a")],
            [PdbDesc("pdb", "team-b", {"app": "svc"}, max_unavailable=1)])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.node == "n2" and tstore.try_get("Pod", "svc-0", "team-b")

    def test_pdb_budget_allows_disruption_within_allowance(self):
        jstore, tstore = self.cluster(
            [self.svc("svc-0", 8, "n1"), self.svc("svc-1", 8, "n2"),
             PodDesc("p", chips(8), ns="team-a")],
            [PdbDesc("pdb", "team-b", {"app": "svc"}, max_unavailable=1)])
        got = cycle(jstore, tstore, "p", "team-a")
        assert len(got.victims) == 1


# ------------------------------------------------------------ gang victim units

class TestGangAtomicPreemption:
    """tests/scheduler/test_preemption.py's gang cases: a gang is evicted
    whole, or not at all."""

    def cluster(self, pods, min_a=4):
        return stores(nodes=[node("n1", 8), node("n2", 8)], pods=pods,
                      quotas=[quota("team-a", min_chips=min_a), quota("team-b")])

    def test_evicting_gang_member_cascades_to_whole_gang(self):
        jstore, tstore = self.cluster([over_quota("g0", 8, "team-b", "n1", "trainer"),
                                       over_quota("g1", 8, "team-b", "n2", "trainer"),
                                       PodDesc("p", chips(4), ns="team-a")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.decision == "nominate"
        assert sorted(got.victims) == ["team-b/g0", "team-b/g1"]
        assert tstore.try_get("Pod", "g0", "team-b") is None
        assert tstore.try_get("Pod", "g1", "team-b") is None

    def test_gang_with_ineligible_member_is_untouchable(self):
        in_quota = running("g1", 8, "team-b", "n2", {
            CAPACITY_LABEL: CAPACITY_IN_QUOTA, "nos.nebuly.com/gang": "trainer",
            "nos.nebuly.com/gang-size": "2"})
        jstore, tstore = self.cluster([over_quota("g0", 8, "team-b", "n1", "trainer"), in_quota,
                                       PodDesc("p", chips(4), ns="team-a")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.decision == "fail"
        assert tstore.try_get("Pod", "g0", "team-b") and tstore.try_get("Pod", "g1", "team-b")

    def test_singleton_preferred_over_gang(self):
        g1 = over_quota("g1", 4, "team-b", "n2", "trainer")
        g1.request = {"cpu": 1}
        jstore, tstore = self.cluster([over_quota("solo", 8, "team-b", "n1"),
                                       over_quota("g0", 8, "team-b", "n2", "trainer"), g1,
                                       PodDesc("p", chips(8), ns="team-a")], min_a=8)
        got = cycle(jstore, tstore, "p", "team-a")
        assert (got.node, got.victims) == ("n1", ["team-b/solo"])
        assert tstore.try_get("Pod", "g0", "team-b") is not None


class TestSpreadAndAffinityAwarePreemption:
    """tests/scheduler/test_preemption.py's overlay cases: the victim
    trials' spread and affinity filters see the cluster after the remote
    evictions."""

    def test_gang_not_destroyed_when_remote_evictions_break_spread(self):
        zone = "topology.kubernetes.io/zone"
        nodes = [PlainNode("n1", {**chips(4), "cpu": 64}, labels={zone: "zone-a", "pool": "a"}),
                 PlainNode("n2", {**chips(8), "cpu": 64}, labels={zone: "zone-b"})]
        pods = [over_quota("w0", 4, "team-b", "n1", "trainer", size=3, app="web")]
        pods += [over_quota(f"w{i}", 4, "team-b", "n2", "trainer", size=3, app="web")
                 for i in (1, 2)]
        pods += [PodDesc(f"anchor-{i}", {"cpu": 1}, ns="team-a", node="n1", phase="Running",
                         priority=100, labels={"app": "web"}) for i in range(2)]
        pods.append(PodDesc("p", chips(4), ns="team-a", labels={"app": "web"},
                            selector={"pool": "a"},
                            spread=[TopologySpreadConstraint(zone, 1, "DoNotSchedule",
                                                             {"app": "web"})]))
        jstore, tstore = stores(nodes=nodes, pods=pods,
                                quotas=[quota("team-a"), quota("team-b")])
        got = cycle(jstore, tstore, "p", "team-a")
        assert got.decision == "fail"
        assert all(tstore.try_get("Pod", f"w{i}", "team-b") for i in range(3))
        assert tstore.get("Pod", "p", "team-a").nominated_node == ""

    def test_eviction_resolves_anti_affinity_violation(self):
        zone = "topology.kubernetes.io/zone"
        jstore, tstore = stores(
            nodes=[PlainNode("n1", {**chips(8), "cpu": 64}, labels={zone: "zone-a"})],
            quotas=[quota("team-a"), quota("team-b")],
            pods=[over_quota("blocker", 8, "team-b", "n1", app="web"),
                  PodDesc("p", chips(4), ns="team-a", labels={"app": "web"},
                          pod_anti_affinity=[PodAffinityTerm(zone, {"app": "web"})])])
        got = cycle(jstore, tstore, "p", "team-a")
        assert (got.decision, got.node, got.victims) == ("nominate", "n1", ["team-b/blocker"])


# ------------------------------------------------------------ MIG headroom

def test_freed_mig_slices_count_toward_a_recarve(tables):
    """A MIG GPU holding two over-quota 4g.40gb: a 7g.80gb fits no
    instance, but the eight memory slices evicting both frees can be
    re-carved into one, so the node is nominated."""
    gpu = NodeDesc("m1", gpus=1, used={0: {"4g.40gb": 2}})
    pods = [PodDesc(f"b{i}", {mig("4g.40gb"): 1}, ns="team-b", node="m1", phase="Running",
                    labels=OVER, created=float(i)) for i in range(2)]
    jstore, tstore = stores(nodes=[(gpu, {mig("4g.40gb"): 2})],
                            quotas=[QuotaDesc("team-a", min={GB: 80}),
                                    QuotaDesc("team-b", min={GB: 0})],
                            pods=pods + [PodDesc("p", {mig("7g.80gb"): 1}, ns="team-a")])
    got = cycle(jstore, tstore, "p", "team-a")
    assert (got.decision, got.node, sorted(got.victims)) == (
        "nominate", "m1", ["team-b/b0", "team-b/b1"])


# ------------------------------------------------------------ random clusters

MPS_PROFILES = ("10gb", "20gb", "40gb")


def random_quota_case(rng, geometries):
    """Nodes, quotas, budgets and running pods, and the preemptor."""
    namespaces = [f"q{i}" for i in range(rng.randint(2, 4))]
    quotas = []
    shared = namespaces[:2] if rng.random() < 0.3 else []
    if shared:
        quotas.append(QuotaDesc("default", min={GB: rng.choice([80, 160, 240])},
                                max=rng.choice([{}, {GB: 320}]), name="shared",
                                namespaces=shared))
    for ns in namespaces:
        if ns in shared:
            continue
        min_gb = rng.choice([0, 40, 80, 120, 160])
        q = QuotaDesc(ns, min={GB: min_gb})
        if rng.random() < 0.4:
            q.max = {GB: min_gb + rng.choice([0, 40, 160])}
        if rng.random() < 0.2:
            q.min["cpu"] = rng.choice([2, 8])
        quotas.append(q)
    nodes, pods = [], []
    created = iter(range(0, 1000))
    for i in range(rng.randint(1, 4)):
        if rng.random() < 0.7:
            desc = NodeDesc(f"m{i}", gpus=rng.randint(1, 2))
            geometry = [rng.choice(geometries) for _ in range(desc.gpus)]
            advertised = {}
            for g in geometry:
                for profile, n in g.items():
                    advertised[mig(profile)] = advertised.get(mig(profile), 0) + n
        else:
            desc = NodeDesc(f"s{i}", gpus=rng.randint(1, 2), mode="mps")
            advertised = {mps(p): rng.randint(1, 3) for p in rng.sample(MPS_PROFILES, 2)}
        nodes.append((desc, advertised))
        for resource, n in sorted(advertised.items()):
            for k in range(n):
                if rng.random() < 0.75:
                    t = next(created)
                    # MIG pods at even instants, MPS pods at odd ones
                    t = 2 * t + (desc.mode == "mps")
                    pod = PodDesc(f"r-{desc.name}-{resource[11:]}-{k}", {resource: 1},
                                  ns=rng.choice(namespaces + ["free"]), node=desc.name,
                                  phase="Running", priority=rng.choice([0, 0, 5, 10]),
                                  created=float(t))
                    if rng.random() < 0.2:
                        pod.request["cpu"] = rng.randint(1, 2)
                    if rng.random() < 0.25:
                        pod.labels["app"] = "svc"
                    pods.append(pod)
    pdbs = []
    if rng.random() < 0.4:
        ns = rng.choice(namespaces)
        pdbs.append(PdbDesc("pdb", ns, {"app": "svc"},
                            **rng.choice([{"min_available": 1}, {"max_unavailable": 1},
                                          {"max_unavailable": 0}])))
    if rng.random() < 0.6:
        request = {mig(rng.choice(MIG_PROFILES)): 1}
    else:
        request = {mps(rng.choice(MPS_PROFILES)): 1}
    if rng.random() < 0.2:
        request["cpu"] = rng.randint(1, 4)
    preemptor = PodDesc("pre", request, ns=rng.choice(namespaces + namespaces + ["free"]),
                        priority=rng.choice([0, 5, 10, 20]), created=5000.0)
    return nodes, quotas, pdbs, pods, preemptor


def reconcile_both(jstore, tstore):
    """Both sides' quota controllers over every quota: composites first."""
    for q in jstore.list("CompositeElasticQuota"):
        JCompositeReconciler(jstore, chip_memory_gb=CHIP_MEMORY_GB).reconcile(
            Request(name=q.metadata.name, namespace=q.metadata.namespace))
    for q in jstore.list("ElasticQuota"):
        JReconciler(jstore, chip_memory_gb=CHIP_MEMORY_GB).reconcile(
            Request(name=q.metadata.name, namespace=q.metadata.namespace))
    ElasticQuotaController(tstore).step()
    for kind in ("ElasticQuota", "CompositeElasticQuota"):
        want = {(q.metadata.namespace, q.metadata.name): to_port(q.status.used)
                for q in jstore.list(kind)}
        got = {(q.namespace, q.name): q.used for q in tstore.list(kind)}
        assert got == want
    want_pods, got_pods = pod_view(jstore, tstore)
    assert got_pods == want_pods


@pytest.mark.parametrize("seed", range(40))
def test_preemption_matches_the_reference_on_random_clusters(tables, seed):
    nodes, quotas, pdbs, pods, preemptor = random_quota_case(random.Random(8000 + seed),
                                                             tables)
    jstore, tstore = stores(nodes=nodes, quotas=quotas, pdbs=pdbs, pods=pods + [preemptor])
    reconcile_both(jstore, tstore)
    cycle(jstore, tstore, preemptor.name, preemptor.ns)
    reconcile_both(jstore, tstore)


def decorate_quota_case(rng, pods, preemptor, nodes):
    """Gangs among the running pods (members sharing a namespace), zones
    on the nodes, and spread or anti-affinity terms on the preemptor and
    some running pods, from a generator of their own."""
    zone = "topology.kubernetes.io/zone"
    for desc, _ in nodes:
        desc.labels[zone] = rng.choice(["z1", "z2"])
    for pod in pods:
        pod.labels.setdefault("app", rng.choice(["web", "db"]))
        roll = rng.random()
        if roll < 0.3:
            pod.labels.update({"nos.nebuly.com/gang": f"{pod.ns}-g{rng.randint(0, 1)}",
                               "nos.nebuly.com/gang-size": str(rng.randint(2, 3))})
        elif roll < 0.4:
            pod.pod_anti_affinity = [PodAffinityTerm(zone, {"app": rng.choice(["web", "db"])})]
    preemptor.labels["app"] = rng.choice(["web", "db"])
    roll = rng.random()
    if roll < 0.3:
        preemptor.spread = [TopologySpreadConstraint(zone, rng.choice([1, 2]), "DoNotSchedule",
                                                     {"app": preemptor.labels["app"]})]
    elif roll < 0.5:
        preemptor.pod_anti_affinity = [PodAffinityTerm(zone, {"app": preemptor.labels["app"]})]


@pytest.mark.parametrize("seed", range(40))
def test_preemption_with_gangs_and_terms_matches_the_reference_on_random_clusters(tables,
                                                                                   seed):
    """The 40 random clusters with gangs among their running pods and
    spread or anti-affinity terms: decisions, victims (whole gangs),
    labels and the quotas' used agree."""
    nodes, quotas, pdbs, pods, preemptor = random_quota_case(random.Random(8000 + seed),
                                                             tables)
    decorate_quota_case(random.Random(13000 + seed), pods, preemptor, nodes)
    jstore, tstore = stores(nodes=nodes, quotas=quotas, pdbs=pdbs, pods=pods + [preemptor])
    reconcile_both(jstore, tstore)
    cycle(jstore, tstore, preemptor.name, preemptor.ns)
    reconcile_both(jstore, tstore)


def test_random_clusters_exercise_every_outcome(tables):
    """The 40 cases are not all one decision: they bind, nominate and
    fail, and some victims are reclaimed across quotas."""
    decisions, cross = set(), 0
    for seed in range(40):
        nodes, quotas, pdbs, pods, preemptor = random_quota_case(random.Random(8000 + seed),
                                                                 tables)
        _, tstore = stores(nodes=nodes, quotas=quotas, pdbs=pdbs, pods=pods + [preemptor])
        ElasticQuotaController(tstore).step()
        sched = Scheduler(tstore)
        outcome = sched.schedule_one(tstore.get("Pod", "pre", preemptor.ns))
        decisions.add(outcome.decision)
        cross += any(v["quota"] != r["quota"] for r in sched.preemptions for v in r["victims"])
    assert decisions == {"bind", "nominate", "fail"} and cross > 0


# ------------------------------------------------------------ SimCluster

def test_sim_cluster_closes_the_quota_loop():
    """team-a borrows a whole MIG node past its min; team-b, within its
    min, then claims its share: the over-quota borrowers are preempted,
    their slices re-carved for team-b's profile, and every invariant
    holds, the quotas' three among them."""
    cluster = SimCluster()
    cluster.add_mig_node("m0", gpus=2)
    cluster.add_quota("team-a", {GB: 80})
    cluster.add_quota("team-b", {GB: 80}, max={GB: 80})
    for i in range(4):
        cluster.store.create(Pod(f"a{i}", "team-a", request={mig("3g.40gb"): 1}))
    assert cluster.run_until_idle(400)
    pods = {p.name: p for p in cluster.store.list("Pod")}
    assert all(p.phase == PodPhase.RUNNING for p in pods.values())
    labels = sorted(p.labels[CAPACITY_LABEL] for p in pods.values())
    assert labels == [CAPACITY_IN_QUOTA] * 2 + [CAPACITY_OVER_QUOTA] * 2
    assert cluster.store.get("ElasticQuota", "quota", "team-a").used == {GB: 160}
    # team-b claims a 7g.80gb: only two over-quota 3g.40gb on one GPU make room
    cluster.store.create(Pod("b0", "team-b", request={mig("7g.80gb"): 1}))
    assert cluster.run_until_idle(400)
    b0 = cluster.store.get("Pod", "b0", "team-b")
    assert b0.phase == PodPhase.RUNNING and b0.nominated_node == ""
    records = list(cluster.scheduler.preemptions)
    assert records and all(v["capacity"] == CAPACITY_OVER_QUOTA
                           for r in records for v in r["victims"])
    left = [p for p in cluster.store.list("Pod") if p.namespace == "team-a"]
    assert len(left) == 2 and all(p.labels[CAPACITY_LABEL] == CAPACITY_IN_QUOTA for p in left)
    assert cluster.pool.geometry("m0") in ({0: {"3g.40gb": 2}, 1: {"7g.80gb": 1}},
                                           {0: {"7g.80gb": 1}, 1: {"3g.40gb": 2}})
    checks = cluster.check()
    assert all(checks.values()), checks
    assert cluster.store.get("ElasticQuota", "quota", "team-b").used == {GB: 80}
    # team-b is at its max: one more is refused by the quota, with a reason
    cluster.store.create(Pod("b1", "team-b", request={mig("1g.10gb"): 1}))
    assert cluster.run_until_idle(400)
    assert cluster.unserved()["team-b/b1"] == "quota eq/team-b/quota: max exceeded"
    assert all(cluster.check().values())
