"""Incremental planning (the snapshot's ``refresh_node``, the planner's
plan modes and carve-futility memo, the store's change journal, the
``IncrementalSnapshotMaintainer``, the partitioner's divergence and
capacity-freed triggers) against nos_tpu's.

The reference's tests, counterpart for counterpart, on the translated
clusters of tests/torch_planner_cases.py (a v5e board ↔ an H100, 1x1 /
1x2 / 2x2 / 2x4 ↔ 1g.10gb / 2g.20gb / 4g.40gb / 7g.80gb, one
allowed-geometry table on both sides, one monotonic instant):
``tests/partitioning/test_incremental_plan.py`` without its
``InvariantAuditor`` cases (the auditor waits for a later slice),
``tests/partitioning/test_futility_memo.py`` and
``tests/controllers/test_divergence.py`` (the port's controller polls,
so a reconcile is a call with the node; a MIG agent that cannot create
its spec stands for the TPU agent's clamp). On the random delta
sequences both sides plan incrementally on persistent bases refreshed
alike: the port's desired state equals the reference's, and the port's
incremental plan equals its own full plan of the same state (state and
unserved reasons). The reference runs as ``RefPlanner`` (F1 and F3
repaired, tests/test_torch_planner.py). The maintainer tests drive the
port's (over the store's change journal) beside the reference's (over
its watch) with the same writes.
"""
import random
import time

import pytest

from nos_tpu.partitioning.core import Planner as JPlanner
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.partitioner import PartitionerController
from nos_tpu_torch.controllers.partitioner.incremental import IncrementalSnapshotMaintainer
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.kube.store import (
    JOURNAL_LENGTH,
    NodeStore,
    Pod,
    PodAffinityTerm,
    PodPhase,
)
from nos_tpu_torch.partitioning.core import ClusterState, Planner
from nos_tpu_torch.partitioning.core.planner import gang_excluded_reason, lacking_reason
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler import Framework
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.util import metrics
from tests.test_torch_planner import (
    NOW,
    RefPlanner,
    _compare_snapshots,
    frameworks,
    placements,
    plan_both,
    random_mig_case,
    snapshots,
)
from tests.torch_planner_cases import (
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    port_state,
    ref_pod,
    ref_state,
    same_tables,
)


def mig(profile):
    return f"nvidia.com/mig-{profile}"


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    with same_tables() as geometries:
        yield geometries


# One-GPU fill styles a delta sequence rotates nodes through, the
# reference's STYLES translated (a 2x4 board ↔ one H100).
STYLES = [
    ({}, {}),  # virgin
    ({0: {"1g.10gb": 2}}, {0: {"4g.40gb": 1}}),
    ({0: {"1g.10gb": 1}}, {0: {"4g.40gb": 1, "1g.10gb": 1}}),
    ({0: {"4g.40gb": 1}}, {0: {"4g.40gb": 1}}),
    ({}, {0: {"7g.80gb": 1}}),  # fully allocated
]


def style_desc(name, style):
    free, used = STYLES[style % len(STYLES)]
    return NodeDesc(name, free={g: dict(p) for g, p in free.items()},
                    used={g: dict(p) for g, p in used.items()})


def bases(styles):
    """(reference, port) snapshots of the styled nodes."""
    return snapshots([style_desc(n, s) for n, s in sorted(styles.items())])


def node_pair(name, style):
    jsnap, tsnap = snapshots([style_desc(name, style)])
    return jsnap.get_nodes()[name], tsnap.get_nodes()[name]


def refresh_both(jbase, tbase, name, style):
    jnode, tnode = node_pair(name, style)
    jbase.refresh_node(name, jnode)
    tbase.refresh_node(name, tnode)


def random_pod(rng, i):
    return PodDesc(f"p{i}", {mig(rng.choice(["1g.10gb", "1g.10gb", "2g.20gb", "4g.40gb",
                                             "7g.80gb"])): 1})


def gang_pair(i):
    return [PodDesc(f"g{i}-{m}", {mig("4g.40gb"): 1},
                    labels={GANG_NAME_LABEL: f"gang{i}", GANG_SIZE_LABEL: "2"})
            for m in range(2)]


def port_full(styles, pods, ages):
    """The oracle: a fresh port snapshot of the same world, a fresh
    planner, a full plan."""
    _, tsnap = bases(styles)
    planner = Planner(frameworks("basic")[1])
    state = planner.plan(tsnap, [port_pod(p) for p in pods], pending_ages=dict(ages))
    return port_state(state), dict(planner.last_unserved)


def plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, dirty):
    jstate = jplanner.plan(jbase, [ref_pod(p) for p in pods], pending_ages=dict(ages),
                           dirty=set(dirty))
    tstate = tplanner.plan(tbase, [port_pod(p) for p in pods], pending_ages=dict(ages),
                           dirty=set(dirty))
    assert tplanner.last_plan_mode == jplanner.last_plan_mode
    assert port_state(tstate) == ref_state(jstate)
    return tstate


# ------------------------------------------------------------ refresh_node

def test_refresh_node_keeps_the_pool_and_versions_as_the_reference(tables):
    styles = {f"n{i}": i for i in range(5)}
    jbase, tbase = bases(styles)
    jbase.free_slice_resources(), tbase.free_slice_resources()
    for name, style in (("n0", 3), ("n4", 1), ("n2", 0)):
        refresh_both(jbase, tbase, name, style)
        _compare_snapshots(jbase, tbase)
        assert tbase.free_slice_resources() == tbase._compute_free_pool()
    assert tbase.node_version("n2") == jbase.node_version("n2") == tbase.state_version
    assert tbase.node_version("nope") == jbase.node_version("nope") == -1


def test_refresh_node_keeps_the_anti_affinity_count():
    desc = NodeDesc("a", used={0: {"1g.10gb": 1}})
    _, tsnap = snapshots([desc, NodeDesc("b")])
    assert not tsnap.has_anti_affinity_pods()
    _, one = snapshots([desc])
    anti = one.get_nodes()["a"]
    anti.pods[0].pod_anti_affinity = [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                                                      match_labels={"app": "x"})]
    tsnap.refresh_node("a", anti)
    assert tsnap.has_anti_affinity_pods()
    _, plain = snapshots([desc])
    tsnap.refresh_node("a", plain.get_nodes()["a"])
    assert not tsnap.has_anti_affinity_pods()


def test_refresh_node_refuses_a_fork_and_an_unknown_node(tables):
    jbase, tbase = bases({"n0": 1})
    jnode, tnode = node_pair("n0", 2)
    for base, node in ((jbase, jnode), (tbase, tnode)):
        with pytest.raises(KeyError):
            base.refresh_node("other", node)
        base.fork()
        with pytest.raises(RuntimeError):
            base.refresh_node("n0", node)
        base.revert()


# ------------------------------------------------------------ incremental = full

@pytest.mark.parametrize("seed", range(10))
def test_randomized_delta_sequences(tables, seed):
    rng = random.Random(seed)
    names = [f"n{i:02d}" for i in range(12)]
    styles = {name: rng.randrange(len(STYLES)) for name in names}
    jbase, tbase = bases(styles)
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = RefPlanner(jframe), Planner(tframe)
    pods = [random_pod(rng, i) for i in range(8)]
    if seed % 2:
        pods += gang_pair(seed)
    ages = {p.key: float(rng.randrange(0, 6)) for p in pods}
    # a cold start on a persistent base: fallback, the base preserved
    plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, names)
    assert tplanner.last_plan_mode == "fallback"
    for step in range(6):
        dirty = set()
        for name in rng.sample(names, rng.randint(1, 3)):
            styles[name] += 1
            refresh_both(jbase, tbase, name, styles[name])
            dirty.add(name)
        if len(pods) > 4 and rng.random() < 0.5:
            gone = pods.pop(rng.randrange(len(pods)))
            ages.pop(gone.key, None)
        if rng.random() < 0.7:
            new = random_pod(rng, 100 * (step + 1) + seed)
            pods.append(new)
            ages[new.key] = float(rng.randrange(0, 6))
        before = port_state(tbase.partitioning_state())
        tstate = plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, dirty)
        assert tplanner.last_plan_mode == "incremental", f"step={step}"
        want_state, want_unserved = port_full(styles, pods, ages)
        assert port_state(tstate) == want_state, f"seed={seed} step={step}"
        assert tplanner.last_unserved == want_unserved, f"seed={seed} step={step}"
        # the base still shows the observed state, its pool exact
        assert port_state(tbase.partitioning_state()) == before
        assert tbase.free_slice_resources() == tbase._compute_free_pool()
        assert not tbase.forked
        _compare_snapshots(jbase, tbase)


def test_aged_rescue_path_matches(tables):
    styles = {f"n{i}": 1 for i in range(6)}
    jbase, tbase = bases(styles)
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = RefPlanner(jframe), Planner(tframe)
    pods = [PodDesc(f"p{i}", {mig("2g.20gb"): 1}) for i in range(4)]
    ages = {p.key: 30.0 for p in pods}
    plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, styles)
    styles["n0"] = 0
    refresh_both(jbase, tbase, "n0", 0)
    tstate = plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, {"n0"})
    assert tplanner.last_plan_mode == "incremental"
    assert (port_state(tstate), tplanner.last_unserved) == port_full(styles, pods, ages)


def test_dirty_fraction_over_threshold_falls_back_and_matches(tables):
    styles = {f"n{i}": i % len(STYLES) for i in range(8)}
    jbase, tbase = bases(styles)
    jframe, tframe = frameworks("basic")
    jplanner = RefPlanner(jframe, incremental_dirty_threshold=0.25)
    tplanner = Planner(tframe, incremental_dirty_threshold=0.25)
    pods = [PodDesc(f"p{i}", {mig("1g.10gb"): 1}) for i in range(6)]
    ages = {p.key: 0.0 for p in pods}
    plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, styles)
    dirty = set()
    for name in ["n0", "n1", "n2", "n3"]:  # 50% > 25%
        styles[name] += 1
        refresh_both(jbase, tbase, name, styles[name])
        dirty.add(name)
    tstate = plan_incremental(jplanner, tplanner, jbase, tbase, pods, ages, dirty)
    assert tplanner.last_plan_mode == "fallback"
    assert (port_state(tstate), tplanner.last_unserved) == port_full(styles, pods, ages)
    assert tbase.free_slice_resources() == tbase._compute_free_pool()


def test_foreign_snapshot_object_falls_back(tables):
    styles = {f"n{i}": 1 for i in range(4)}
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = RefPlanner(jframe), Planner(tframe)
    pods = [PodDesc("p0", {mig("1g.10gb"): 1})]
    jbase, tbase = bases(styles)
    plan_incremental(jplanner, tplanner, jbase, tbase, pods, {}, {"n0"})
    assert tplanner.last_plan_mode == "fallback"
    jother, tother = bases(styles)
    tstate = plan_incremental(jplanner, tplanner, jother, tother, pods, {}, {"n0"})
    assert tplanner.last_plan_mode == "fallback"
    assert port_state(tstate) == port_full(styles, pods, {})[0]


def test_dirty_none_is_the_full_mode(tables):
    jbase, tbase = bases({f"n{i}": 1 for i in range(4)})
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = RefPlanner(jframe), Planner(tframe)
    pod = PodDesc("p0", {mig("7g.80gb"): 1})
    jplanner.plan(jbase, [ref_pod(pod)])
    tplanner.plan(tbase, [port_pod(pod)])
    assert tplanner.last_plan_mode == jplanner.last_plan_mode == "full"
    assert not tbase.forked
    # the full mode leaves the plan's carves and placements in the snapshot
    assert placements(tbase) == placements(jbase)


# ------------------------------------------------------------ the futility memo

@pytest.mark.parametrize("seed", range(10))
def test_plan_identical_with_and_without_memo(tables, seed):
    nodes, pods, ages = random_mig_case(random.Random(2000 + seed), tables)
    on = plan_both(nodes, pods, framework="vanilla", ages=ages, futility=True)
    off = plan_both(nodes, pods, framework="vanilla", ages=ages, futility=False)
    assert port_state(on[0]) == port_state(off[0])
    assert on[1].last_unserved == off[1].last_unserved
    assert placements(on[2]) == placements(off[2])
    assert off[1]._futility_hits == 0


def _two_pass_case():
    """frag-0: one free 1g.10gb beside used instances (a carve toward a
    2g.20gb there changes nothing); half-0: one free 4g.40gb. A gang of
    two with one member asking for that 4g.40gb cannot form, so the trial
    pass (which claims it and tries frag-0 for the 2g.20gb pod) is
    reverted and a second pass runs: it meets frag-0 at the same version
    with the same lacking profile."""
    nodes = [NodeDesc("frag-0", free={0: {"1g.10gb": 1}},
                      used={0: {"4g.40gb": 1, "2g.20gb": 1, "1g.10gb": 1}}),
             NodeDesc("half-0", free={0: {"4g.40gb": 1}}, used={0: {"4g.40gb": 1}})]
    pods = [PodDesc("gm", {mig("2g.20gb"): 1}),
            PodDesc("g0", {mig("4g.40gb"): 1},
                    labels={GANG_NAME_LABEL: "pair", GANG_SIZE_LABEL: "2"})]
    return nodes, pods


def test_two_pass_gang_plan_hits_the_memo(tables):
    nodes, pods = _two_pass_case()
    before = metrics.PLAN_CARVE_FUTILITY.value
    _, planner, snapshot = plan_both(nodes, pods)
    assert planner._futility_hits == 1  # plan_both: the reference's too
    assert "gm" in placements(snapshot)["half-0"]
    assert not snapshot.forked
    assert metrics.PLAN_CARVE_FUTILITY.value - before == 1


def test_memo_off_re_runs_the_futile_trial(tables):
    nodes, pods = _two_pass_case()
    on = plan_both(nodes, pods, futility=True)
    off = plan_both(nodes, pods, futility=False)
    assert off[1]._futility_hits == 0
    assert port_state(on[0]) == port_state(off[0])
    assert placements(on[2]) == placements(off[2])


def test_memoized_reason_is_the_canonical_lacking_reason(tables):
    nodes, pods = _two_pass_case()
    _, planner, _ = plan_both(nodes, pods)
    key = ("frag-0", 0, ((mig("2g.20gb"), 1),))
    assert planner._futility_cache[key] == lacking_reason({mig("2g.20gb"): 1})
    assert "no node can be re-carved" in JPlanner._lacking_reason({"x": 1})


def test_served_absent_unserved_present_with_lacking_reason(tables):
    nodes = [NodeDesc("half-0", free={0: {"4g.40gb": 1}}, used={0: {"4g.40gb": 1}})]
    pods = [PodDesc("ok", {mig("2g.20gb"): 1}, ns="ml"),
            PodDesc("big", {mig("7g.80gb"): 1}, ns="ml")]
    _, planner, snapshot = plan_both(nodes, pods)
    assert "ok" in placements(snapshot)["half-0"]
    assert planner.last_unserved == {"ml/big": lacking_reason({mig("7g.80gb"): 1})}


def test_half_formable_gang_gets_the_gang_reason(tables):
    nodes = [NodeDesc("frag-0", free={0: {"1g.10gb": 1}},
                      used={0: {"4g.40gb": 1, "2g.20gb": 1, "1g.10gb": 1}})]
    pods = [PodDesc("gm", {mig("4g.40gb"): 1},
                    labels={GANG_NAME_LABEL: "gm", GANG_SIZE_LABEL: "1"})]
    _, planner, _ = plan_both(nodes, pods)
    assert planner.last_unserved == {"default/gm": gang_excluded_reason("default/gm")}


def test_fully_served_plan_leaves_it_empty(tables):
    nodes = [NodeDesc("half-0", free={0: {"4g.40gb": 1}}, used={0: {"4g.40gb": 1}})]
    _, planner, snapshot = plan_both(nodes, [PodDesc("fit", {mig("4g.40gb"): 1}, ns="ml")])
    assert planner.last_unserved == {}
    assert not snapshot.forked


# ------------------------------------------------------------ the maintainer

def _ref_store_and_taker():
    from nos_tpu.cmd.partitioner import register_indexers
    from nos_tpu.kube.store import KubeStore
    from nos_tpu.partitioning.tpu import TpuSnapshotTaker

    store = KubeStore()
    register_indexers(store)
    return store, TpuSnapshotTaker()


class _Both:
    """The same nodes on both sides, each with its maintainer."""

    def __init__(self, n=5):
        from nos_tpu.controllers.partitioner.incremental import (
            IncrementalSnapshotMaintainer as JMaintainer,
        )
        from nos_tpu.partitioning.core import ClusterState as JState
        from tests.torch_planner_cases import ref_node

        self.jstore, jtaker = _ref_store_and_taker()
        self.tstore = NodeStore()
        for i in range(n):
            desc = NodeDesc(f"n{i}", free={0: {"1g.10gb": 2}}, used={0: {"4g.40gb": 1}})
            self.jstore.create(ref_node(desc))
            self.tstore.create(port_node(desc))
        self.jm = JMaintainer(self.jstore, jtaker, kind="tpu")
        self.tm = IncrementalSnapshotMaintainer(self.tstore, MigSnapshotTaker(), "mig")
        self.jstate, self.tstate = JState(), ClusterState()

    def snapshot(self):
        # the port's controller syncs its state from the store each step
        self.tstate = ClusterState()
        for node in self.tstore.list("Node"):
            self.tstate.update_node(node, [p for p in self.tstore.list("Pod")
                                           if p.node == node.name
                                           and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)])
        jbase, jdirty = self.jm.snapshot(self.jstate)
        tbase, tdirty = self.tm.snapshot(self.tstate)
        assert tdirty == jdirty
        assert self.tm.full_rebuilds == self.jm.full_rebuilds
        return tbase, tdirty


def test_refresh_matches_full_rebuild(tables):
    both = _Both()
    base, dirty = both.snapshot()
    assert dirty == set(base.get_nodes()) and both.tm.full_rebuilds == 1
    bound = PodDesc("w0", {mig("1g.10gb"): 1}, node="n2", phase="Running")
    both.jstore.create(ref_pod(bound))
    both.tstore.create(port_pod(bound))
    base2, dirty2 = both.snapshot()
    assert base2 is base and dirty2 == {"n2"} and both.tm.full_rebuilds == 1
    fresh = MigSnapshotTaker().take_snapshot(both.tstate)
    assert port_state(base2.partitioning_state()) == port_state(fresh.partitioning_state())
    assert [p.name for p in base2.get_nodes()["n2"].pods if p.namespace == "default"] == ["w0"]


def test_node_delete_forces_rebuild(tables):
    both = _Both()
    base, _ = both.snapshot()
    both.jstore.delete("Node", "n1")
    both.tstore.delete("Node", "n1")
    base2, dirty2 = both.snapshot()
    assert base2 is not base and "n1" not in base2.get_nodes()
    assert dirty2 == set(base2.get_nodes()) and both.tm.full_rebuilds == 2


def _quotas():
    from tests.torch_quota_cases import GB, QuotaDesc, port_quota, ref_quota

    return GB, QuotaDesc, port_quota, ref_quota


def test_status_only_quota_update_preserves_base(tables):
    GB, QuotaDesc, port_quota, ref_quota = _quotas()
    both = _Both()
    q = QuotaDesc("default", min={GB: 80}, max={GB: 80}, name="q")
    both.jstore.create(ref_quota(q))
    both.tstore.create(port_quota(q))
    base, _ = both.snapshot()

    def bump(quota):
        quota.status.used = {"nos.nebuly.com/tpu-memory": 40}

    both.jstore.patch_merge("ElasticQuota", "q", "default", bump)
    both.tstore.patch_merge("ElasticQuota", "q", "default",
                            lambda quota: setattr(quota, "used", {GB: 40}))
    base2, dirty2 = both.snapshot()
    assert base2 is base and dirty2 == set() and both.tm.full_rebuilds == 1


def test_quota_spec_change_forces_rebuild(tables):
    GB, QuotaDesc, port_quota, ref_quota = _quotas()
    both = _Both()
    q = QuotaDesc("default", min={GB: 80}, max={GB: 80}, name="q")
    both.jstore.create(ref_quota(q))
    both.tstore.create(port_quota(q))
    base, _ = both.snapshot()

    def shrink(quota):
        quota.spec.max = {"nos.nebuly.com/tpu-memory": 40}

    both.jstore.patch_merge("ElasticQuota", "q", "default", shrink)
    both.tstore.patch_merge("ElasticQuota", "q", "default",
                            lambda quota: setattr(quota, "max", {GB: 40}))
    base2, _ = both.snapshot()
    assert base2 is not base and both.tm.full_rebuilds == 2
    q2 = QuotaDesc("default", min={GB: 80}, max={GB: 80}, name="q2")
    both.jstore.create(ref_quota(q2))
    both.tstore.create(port_quota(q2))
    both.snapshot()
    assert both.tm.full_rebuilds == 3
    both.jstore.delete("ElasticQuota", "q2", "default")
    both.tstore.delete("ElasticQuota", "q2", "default")
    both.snapshot()
    assert both.tm.full_rebuilds == 4


def test_journal_overflow_forces_rebuild(monkeypatch):
    from nos_tpu_torch.kube import store as store_mod

    assert JOURNAL_LENGTH == 10_000
    monkeypatch.setattr(store_mod, "JOURNAL_LENGTH", 50)
    store = NodeStore()
    store.create(port_node(NodeDesc("n0", free={0: {"1g.10gb": 2}})))
    maintainer = IncrementalSnapshotMaintainer(store, MigSnapshotTaker(), "mig")
    state = ClusterState()
    state.update_node(store.get("Node", "n0"), [])
    maintainer.snapshot(state)
    for i in range(51):
        store.create(Pod(f"p{i}", "ns"))
    assert store.changes_since(1) is None
    assert len(store.changes_since(store.revision - 3)) == 3
    maintainer.snapshot(state)
    assert maintainer.full_rebuilds == 2


def test_journal_records_binds_and_quota_status_writes():
    from nos_tpu_torch.api.v1alpha1 import ElasticQuota

    store = NodeStore()
    cursor = store.revision
    store.create(Pod("p", "ns"))
    store.patch_merge("Pod", "p", "ns", lambda p: setattr(p, "node", "n1"))
    store.create(ElasticQuota("q", "ns", {"x": 1}))
    store.patch_merge("ElasticQuota", "q", "ns", lambda q: setattr(q, "used", {"x": 1}))
    store.patch_merge("ElasticQuota", "q", "ns", lambda q: setattr(q, "max", {"x": 2}))
    store.delete("Pod", "p", "ns")
    changes = store.changes_since(cursor)
    assert [(c.kind, c.type) for c in changes] == [
        ("Pod", "ADDED"), ("Pod", "MODIFIED"), ("ElasticQuota", "ADDED"),
        ("ElasticQuota", "MODIFIED"), ("ElasticQuota", "MODIFIED"), ("Pod", "DELETED")]
    assert (changes[1].node_before, changes[1].node_after) == ("", "n1")
    assert (changes[5].node_before, changes[5].node_after) == ("n1", "")
    assert [c.spec_changed for c in changes[3:5]] == [False, True]
    assert store.changes_since(store.revision) == []


# ------------------------------------------------------------ divergence

def _divergence_store(pending=True):
    store = NodeStore()
    store.create(port_node(NodeDesc("n1")))
    if pending:
        store.create(Pod("pend", "default", request={mig("3g.40gb"): 1}, unschedulable=True))
    controller = PartitionerController(store, ClusterState(), None, Planner(Framework()), None,
                                       "mig", lambda name: name.startswith("nvidia.com/mig-"),
                                       60.0, 60.0, clock=lambda: 0.0)
    return store, controller


def _set_annotations(store, spec, status_free, spec_plan, status_plan, name="n1"):
    def mutate(node):
        for key in [k for k in node.annotations if k.startswith("nos.nebuly.com/")]:
            del node.annotations[key]
        node.annotations.update(tannot.spec_from_geometries(spec))
        node.annotations.update(tannot.status_from_devices(status_free, {}))
        node.annotations[tannot.SPEC_PARTITIONING_PLAN] = spec_plan
        node.annotations[tannot.STATUS_PARTITIONING_PLAN] = status_plan

    store.patch_merge("Node", name, "", mutate)


def _reconcile(store, controller, name="n1"):
    return controller.reconcile_node_divergence(store.get("Node", name))


def test_acked_divergent_node_fires_immediate_replan():
    store, c = _divergence_store()
    # acknowledged plan p1, but one 3g.40gb where the spec wants two
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 1}}, "p1", "p1")
    before = metrics.DIVERGENCE_REPLANS.value
    assert _reconcile(store, c) == "replan"
    assert c.batcher.poll() == []  # an immediate, empty release
    assert metrics.DIVERGENCE_REPLANS.value == before + 1
    # the same stale plan: one replan only
    assert _reconcile(store, c) == "replanned_already"
    assert c.batcher.poll() is None


def test_handshake_in_flight_defers_to_plan_gate():
    store, c = _divergence_store()
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 1}}, "p2", "p1")
    assert _reconcile(store, c) == "in_flight"
    assert c.batcher.poll() is None


def test_converged_node_clears_memo():
    store, c = _divergence_store()
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 1}}, "p1", "p1")
    assert _reconcile(store, c) == "replan" and c.batcher.poll() == []
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 2}}, "p2", "p2")
    assert _reconcile(store, c) == "converged"
    assert c.batcher.poll() is None and "n1" not in c._diverged
    _set_annotations(store, {0: {"7g.80gb": 1}}, {0: {"3g.40gb": 2}}, "p3", "p3")
    assert _reconcile(store, c) == "replan" and c.batcher.poll() == []


def test_other_kind_node_ignored():
    store, c = _divergence_store()
    store.create(port_node(NodeDesc("s1", mode="mps")))
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 1}}, "p1", "p1", name="s1")
    assert _reconcile(store, c, "s1") == "other_kind"
    assert c.batcher.poll() is None


def test_no_pending_pods_spec_adopts_reported_geometry():
    store, c = _divergence_store(pending=False)
    _set_annotations(store, {0: {"3g.40gb": 2}}, {0: {"3g.40gb": 1}}, "p1", "p1")
    before = metrics.DIVERGENCE_REPLANS.value
    assert _reconcile(store, c) == "adopted"
    assert metrics.DIVERGENCE_REPLANS.value == before + 1
    assert c.batcher.poll() is None
    spec, status = tannot.parse_node_annotations(store.get("Node", "n1").annotations)
    assert tannot.spec_geometries(spec) == tannot.status_geometries(status)
    assert store.get("Node", "n1").annotations[tannot.SPEC_PARTITIONING_PLAN] == "p1"
    assert _reconcile(store, c) == "converged"
    assert metrics.DIVERGENCE_REPLANS.value == before + 1


def test_infeasible_spec_recovers_without_a_batch_window():
    """A stale infeasible spec (two 7g.80gb on a one-GPU node) must not
    starve a pending pod: the agent creates what fits and acknowledges,
    the divergence replans at once, the pod runs. The batch windows are
    30 virtual seconds, so only the divergence can explain a prompt bind."""
    c = SimCluster()
    c.add_mig_node("m0", gpus=1)
    for controller in c.controllers:
        controller.batcher.timeout = controller.batcher.idle = 30.0
    c.store.patch_annotations("Node", "m0", "", {
        **tannot.spec_from_geometries({0: {"7g.80gb": 2}}),
        tannot.SPEC_PARTITIONING_PLAN: "stale-1"})
    c.store.create(Pod("train", "ml", request={mig("3g.40gb"): 1}))
    for _ in range(100):  # 5 virtual seconds
        c.step()
        pod = c.store.get("Pod", "train", "ml")
        if pod.phase == PodPhase.RUNNING:
            break
    assert pod.phase == PodPhase.RUNNING and pod.node == "m0"
    assert c.now < 30.0


def _f4_cluster(incremental):
    """F4's input on a loop: seven 1g.10gb instances, six pods gone; the
    instance left blocks the one placement a 4g.40gb has, which a count
    cannot see."""
    c = SimCluster(incremental_planning=incremental)
    c.add_mig_node("m0", gpus=1)
    for i in range(7):
        c.store.create(Pod(f"s{i}", "default", request={mig("1g.10gb"): 1}))
    assert c.run_until_idle(200)
    for i in range(1, 7):
        c.store.delete("Pod", f"s{i}", "default")
    assert c.run_until_idle(200)
    return c


@pytest.mark.parametrize("incremental", [True, False])
def test_f4_input_goes_idle_with_divergence_on(incremental):
    """F4's refusal memo and the divergence replan together: each refused
    geometry is replanned once, the loop goes idle with the pod unserved
    and a reason, and no node is re-planned on later steps."""
    c = _f4_cluster(incremental)
    before = metrics.DIVERGENCE_REPLANS.value
    c.store.create(Pod("big", "default", request={mig("4g.40gb"): 1}))
    assert c.run_until_idle(300)
    replans = metrics.DIVERGENCE_REPLANS.value - before
    assert 0 < replans <= 4
    assert "4g.40gb" in c.unserved()["default/big"]
    assert all(c.check().values())
    applied = c.mig.plans_applied
    for _ in range(50):
        c.step()
    assert c.mig.plans_applied == applied
    assert metrics.DIVERGENCE_REPLANS.value - before == replans


# ------------------------------------------------------------ finished pods

def test_finished_pods_free_their_capacity_everywhere():
    """A pod turning Succeeded counts nowhere: the pod-resources sim and
    the device plugin, the scheduler's views, the snapshot, the quota's
    used and the sim kubelet; its instances are placed again, and a pod
    needing a re-carve is planned the step its capacity frees."""
    from tests.torch_quota_cases import GB

    c = SimCluster()
    c.add_mig_node("m0", gpus=1)
    c.add_quota("ml", {GB: 80})
    c.store.create(Pod("a", "ml", request={mig("7g.80gb"): 1}))
    assert c.run_until_idle(100) and c.store.get("Pod", "a", "ml").phase == PodPhase.RUNNING
    c.store.create(Pod("b", "ml", request={mig("3g.40gb"): 2}))
    assert c.run_until_idle(100)
    assert c.store.get("Pod", "b", "ml").phase == PodPhase.PENDING
    assert c.store.get("ElasticQuota", "quota", "ml").used == {GB: 80}
    fires = c.mig.capacity_freed_fires
    c.store.patch_merge("Pod", "a", "ml", lambda p: setattr(p, "phase", PodPhase.SUCCEEDED))
    agent = c.agents["m0"]
    assert agent.reporter.client.pod_resources.get_used_device_ids() == []
    assert all(p.name != "a" for p in c.scheduler._node_infos()["m0"].pods)
    c.step()
    assert c.mig.capacity_freed_fires == fires + 1
    for _ in range(20):
        if c.store.get("Pod", "b", "ml").phase == PodPhase.RUNNING:
            break
        c.step()
    assert c.store.get("Pod", "b", "ml").phase == PodPhase.RUNNING
    assert c.store.get("ElasticQuota", "quota", "ml").used == {GB: 80}
    c.step()  # the controller syncs what the step's bind wrote
    snapshot = MigSnapshotTaker().take_snapshot(c.mig.cluster_state)
    assert [p.name for p in snapshot.get_nodes()["m0"].pods] == ["b"]
    assert all(c.check().values())


def test_capacity_freed_by_a_preemption_waits_for_the_preemptors_cycle():
    """Room a preemption freed is the nominated pod's: the trigger does
    not plan it away for another pending pod while the nomination stands,
    and fires the step after the scheduler's cycle settled it."""
    c = SimCluster()
    c.add_mig_node("m0", gpus=1)
    c.store.create(Pod("a", "default", request={mig("7g.80gb"): 1}))
    assert c.run_until_idle(100) and c.store.get("Pod", "a", "default").phase == PodPhase.RUNNING
    c.store.create(Pod("c", "default", request={mig("1g.10gb"): 1}))
    c.step()
    assert [p.name for p in c.helpable(c.mig)] == ["c"]
    # what a preemption does: nominate the preemptor, delete its victim
    c.store.create(Pod("b", "default", request={mig("3g.40gb"): 1}))
    c.store.patch_merge("Pod", "b", "default", lambda p: setattr(p, "nominated_node", "m0"))
    c.store.delete("Pod", "a", "default")
    fires, plans = c.mig.capacity_freed_fires, c.mig.plans_processed
    c.step()
    assert (c.mig.capacity_freed_fires, c.mig.plans_processed) == (fires, plans)
    assert c.store.get("Pod", "b", "default").nominated_node == ""
    c.step()
    assert c.mig.capacity_freed_fires == fires + 1
    assert c.run_until_idle(100)
    assert {p.name: p.phase for p in c.store.list("Pod")} == {
        "b": PodPhase.RUNNING, "c": PodPhase.RUNNING}
    assert all(c.check().values())
