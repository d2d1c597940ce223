"""The planner core (nos_tpu_torch.partitioning.core) against nos_tpu's.

Exact equality, this logic being integer: the same translated clusters
(tests/torch_planner_cases.py: a v5e node of one 2x4 board per GPU ↔ an
H100 node, topologies ↔ MIG profiles of as many memory slices, the same
allowed-geometry table on both sides; an 80 GB shared chip ↔ an H100
under MPS) go through both planners, and the port's PartitioningState,
last_unserved (reasons with the resource names translated) and
simulated placements must equal the reference's, with the verdict cache
on and off, and the carve-futility memo on and off on both sides
(neither may change a plan; with it on, both skip the same trials). Both planners see one monotonic instant
(``time.monotonic`` patched), so their fairness ages agree to the bit.
The snapshot's fork / commit / revert journal, its free pool and node
versions, the tracker and the snapshot takers are held the same way.

Fault F1 of the reference (ROADMAP.md): its claim pre-pass places the
pod the aged rescue placed a second time, and a pod left unplaced whose
free slices a carve took gets no unserved reason. The port places each
pod at most once and gives every pending pod it leaves lacking a reason.
So the reference runs as ``RefPlanner``, its own planner with a second
placement of a pod in one plan refused (the duplicate then holds no
slice another pod could claim), and the port's ``last_unserved`` must
equal the reference's plus, for each pending pod the reference neither
placed nor gave a reason, the slices that pod lacks in the reference's
final snapshot. Every case also holds both invariants on the port.

Deliberate differences, tested here on the port alone: an MPS slice
counts GB / 10 in the port's largest-first sort where the reference
counts 0 (so the MPS cases give each pod its own priority, which orders
both sides alike), and the reference's best-fit candidate sort raises on
a free shared slice (``topology_chips('8gb')``), so for the MPS cases
its snapshot module is given the port's measure of a slice.
"""
import random
import time

import pytest

from nos_tpu.partitioning.core import ClusterSnapshot as JSnapshot
from nos_tpu.partitioning.core import Planner as JPlanner
from nos_tpu.partitioning.core import SliceTracker as JTracker
from nos_tpu.partitioning.core import SnapshotNode as JSnapNode
from nos_tpu.partitioning.core import planner as jplanner_mod
from nos_tpu.partitioning.core import snapshot as jsnapshot_mod
from nos_tpu.partitioning.core.codec import SharedSliceCodec
from nos_tpu.partitioning.core.planner import sort_candidate_pods as jsort
from nos_tpu.partitioning.core.state import ClusterState as JState
from nos_tpu.partitioning.tpu.snapshot_taker import TpuSnapshotTaker
from nos_tpu.scheduler import framework as jfw
from nos_tpu.tpu.node import TpuNode
from nos_tpu.tpu.sharing import SharingNode
from nos_tpu_torch.gpu.node import MigNode, MpsNode
from nos_tpu_torch.partitioning.core import (
    ClusterSnapshot,
    ClusterState,
    MigSliceCodec,
    MpsSliceCodec,
    Planner,
    SliceTracker,
    SnapshotNode,
    sort_candidate_pods,
)
from nos_tpu_torch.partitioning.core.planner import unplaced_reason
from nos_tpu_torch.partitioning.core.verdict_cache import VerdictCache, pod_signature
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler import framework as tfw
from tests.torch_planner_cases import (
    MIG_PROFILES,
    NodeDesc,
    PodDesc,
    eighty_gb_chips,
    nonzero,
    port_node,
    port_pod,
    port_state,
    ref_node,
    ref_pod,
    ref_state,
    ref_unserved,
    running_pods,
    same_tables,
    to_port_resource,
    to_ref_resource,
    translate_pool,
)

NOW = 1000.0


def mig(profile):
    return f"nvidia.com/mig-{profile}"


def mps(profile):
    return f"nvidia.com/gpu-{profile}"


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    with same_tables() as geometries:
        yield geometries


@pytest.fixture
def mps_tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    original = jsnapshot_mod.topology_chips
    monkeypatch.setattr(jsnapshot_mod, "topology_chips",
                        lambda p: int(p[:-2]) / 10 if p.endswith("gb") else original(p))
    with eighty_gb_chips():
        yield


# ------------------------------------------------------------ builders

def snapshots(nodes, pods=(), generic=True):
    """(reference snapshot, port snapshot) of the same translated nodes,
    with ``pods`` on their nodes and, when ``generic``, one running pod
    per used slice."""
    pods = list(pods) + (running_pods(nodes) if generic else [])
    jnodes, tnodes = {}, {}
    for desc in nodes:
        on = [p for p in pods if p.node == desc.name]
        jn, tn = ref_node(desc), port_node(desc)
        if desc.mode == "mig":
            jpart = TpuNode(jn)
            tpart = MigNode(tn.name, tn.labels, tn.capacity, tn.annotations)
        else:
            jpart = SharingNode(jn)
            tpart = MpsNode(tn.name, tn.labels, tn.capacity, tn.annotations)
        jnodes[desc.name] = JSnapNode(partitionable=jpart, pods=[ref_pod(p) for p in on])
        tnodes[desc.name] = SnapshotNode(partitionable=tpart, pods=[port_pod(p) for p in on],
                                         node=tn)
    mode = nodes[0].mode if nodes else "mig"
    if mode == "mps":
        return JSnapshot(jnodes, codec=SharedSliceCodec()), ClusterSnapshot(tnodes,
                                                                            MpsSliceCodec())
    return JSnapshot(jnodes), ClusterSnapshot(tnodes, MigSliceCodec())


def frameworks(kind):
    if kind == "basic":
        return (jfw.Framework(filter_plugins=[jfw.NodeResourcesFit(), jfw.NodeSelectorFit()]),
                tfw.Framework(filter_plugins=[tfw.NodeResourcesFit(), tfw.NodeSelectorFit()]))
    if kind == "vanilla":
        return (jfw.Framework(filter_plugins=jfw.vanilla_filter_plugins()),
                tfw.Framework(filter_plugins=tfw.vanilla_filter_plugins()))
    assert kind == "reject_all"

    class RejectAll:
        name = "RejectAll"

        def __init__(self, status):
            self.status = status

        def filter(self, state, pod, node_info):
            return self.status.unschedulable("no", self.name)

    return (jfw.Framework(filter_plugins=[RejectAll(jfw.Status)]),
            tfw.Framework(filter_plugins=[RejectAll(tfw.Status)]))


def _name(pod):
    return pod.metadata.name if hasattr(pod, "metadata") else pod.name


def placements(snapshot):
    return {name: sorted(_name(p) for p in node.pods)
            for name, node in snapshot.get_nodes().items()}


class _SplitTracker(JTracker):
    """The reference's tracker with the port's ``split``: the pods the
    pool covers whose slices no single node's free slices hold. While
    any is named the tracker is not empty, so the reference runs a pass
    where it would stop; ``_F3Tracker``'s repair clears the names."""

    def __init__(self, snapshot, pods):
        pods = list(pods)
        super().__init__(snapshot, pods)
        node_frees = [{snapshot.codec.resource(p): q
                       for p, q in node.partitionable.free_slices().items()}
                      for node in snapshot.get_nodes().values()]
        self.split = []
        for pod in pods:
            if pod in self:
                continue
            slices = snapshot.take_from_pool({}, pod.spec.containers[0].requests)
            if sum(slices.values()) >= 2 and not any(
                    all(free.get(k, 0) >= q for k, q in slices.items()) for free in node_frees):
                self.split.append(pod.namespaced_name)

    @property
    def empty(self):
        return not self._lacking and not self.split


class _F3Tracker:
    """The reference's tracker for one pass, with the port's repair of F3:
    before the carve loop's first look (``empty``), or at the pass's end
    when the loop had no node to look at, every candidate the rescue and
    the claim pre-pass left unplaced goes back in, its whole request
    lacking."""

    def __init__(self, tracker, snapshot, candidates, placed_keys):
        self._tracker, self._snapshot = tracker, snapshot
        self._candidates, self._placed_keys = candidates, placed_keys
        self._repaired = False

    def repair(self):
        if self._repaired:
            return
        self._repaired = True
        inner = self._tracker
        inner.split = []
        for pod in self._candidates:
            if pod in inner or pod.namespaced_name in self._placed_keys:
                continue
            lacking = self._snapshot.take_from_pool({}, pod.spec.containers[0].requests)
            if not lacking:
                continue
            inner._lacking[pod.namespaced_name] = dict(lacking)
            for accelerator, total in inner._totals_cache.items():
                for name, amount in inner._convert_plain(lacking, accelerator).items():
                    total[name] = total.get(name, 0) + amount

    @property
    def empty(self):
        self.repair()
        return self._tracker.empty

    def __contains__(self, pod):
        return pod in self._tracker

    def __getattr__(self, name):
        return getattr(self._tracker, name)


class RefPlanner(JPlanner):
    """The reference's planner with F1's duplicate placement taken out (a
    pod already placed in the pass is refused a second placement) and the
    port's repair of F3 (``_SplitTracker``, put in the reference planner
    module's place for the plan, and ``_F3Tracker``)."""

    def plan(self, snapshot, pending_pods, *args, **kwargs):
        self.placed_keys = set()
        self.passed = False  # the geometry served every pod: no pass ran
        self.snapshot, self.pods = snapshot, list(pending_pods)
        original = jplanner_mod.SliceTracker
        jplanner_mod.SliceTracker = _SplitTracker
        try:
            return super().plan(snapshot, pending_pods, *args, **kwargs)
        finally:
            jplanner_mod.SliceTracker = original

    def _plan_pass(self, snapshot, tracker, candidates, *args, **kwargs):
        self.passed = True
        self.placed_keys = set()  # a gang trial's placements were reverted
        repaired = _F3Tracker(tracker, snapshot, candidates, self.placed_keys)
        placed = super()._plan_pass(snapshot, repaired, candidates, *args, **kwargs)
        repaired.repair()
        return placed

    def _try_add_pod(self, snapshot, node_name, pod):
        if pod.namespaced_name in self.placed_keys:
            return False
        if super()._try_add_pod(snapshot, node_name, pod):
            self.placed_keys.add(pod.namespaced_name)
            return True
        return False


def expected_unserved(jplanner):
    """The reference's reasons in its last plan, plus one for each pending
    pod asking for slices that it neither placed nor gave a reason: the
    slices it lacks in the reference's final snapshot, else that no node
    it fits holds them."""
    want = ref_unserved(jplanner.last_unserved)
    if not jplanner.passed:
        return want
    jsnap = jplanner.snapshot
    placed = {p.namespaced_name for node in jsnap.get_nodes().values() for p in node.pods}
    for pod in jplanner.pods:
        request = pod.spec.containers[0].requests
        slices = {k: v for k, v in request.items()
                  if k.startswith(("google.com/tpu-slice-", "google.com/tpu-mem-"))}
        if pod.namespaced_name in want or pod.namespaced_name in placed or not slices:
            continue
        lacking = jsnap.get_lacking_slices(pod)
        reason = (JPlanner._lacking_reason(lacking) if lacking
                  else unplaced_reason({to_port_resource(k): v for k, v in slices.items()}))
        want[pod.namespaced_name] = ref_unserved({"": reason})[""]
    return want


def assert_plan_invariants(planner, snapshot, pods, ran_pass=True):
    """Each pod placed at most once; when the plan ran a pass (the free
    slices did not already serve every pod), every pending pod asking for
    slices that it leaves unplaced has a reason."""
    placed = [p.namespaced_name for node in snapshot.get_nodes().values() for p in node.pods]
    assert len(placed) == len(set(placed))
    for pod in pods if ran_pass else ():
        if pod.namespaced_name not in placed and any(
                k.startswith(("nvidia.com/mig-", "nvidia.com/gpu-")) for k in pod.request):
            assert planner.last_unserved.get(pod.namespaced_name), pod.namespaced_name


def plan_both(nodes, pending, framework="basic", ages=None, cache=True, futility=True,
              running=None):
    """Plan both sides; assert the port equals the reference (F1's
    duplicate taken out, its missing reasons given); return the port's
    (state, planner, snapshot). ``running`` replaces the generic running
    pods of the nodes' used slices."""
    jsnap, tsnap = (snapshots(nodes) if running is None
                    else snapshots(nodes, running, generic=False))
    jframe, tframe = frameworks(framework)
    jplanner = RefPlanner(jframe, verdict_cache_enabled=cache, futility_memo_enabled=futility)
    tplanner = Planner(tframe, verdict_cache_enabled=cache, futility_memo_enabled=futility)
    jpods, tpods = [ref_pod(p) for p in pending], [port_pod(p) for p in pending]
    jstate = jplanner.plan(jsnap, jpods, pending_ages=ages)
    tstate = tplanner.plan(tsnap, tpods, pending_ages=ages)
    assert port_state(tstate) == ref_state(jstate)
    # the same futile carves skipped
    assert tplanner._futility_hits == jplanner._futility_hits
    assert tplanner.last_unserved == expected_unserved(jplanner)
    assert placements(tsnap) == placements(jsnap)
    assert_plan_invariants(tplanner, tsnap, tpods, jplanner.passed)
    if cache and not futility:
        # the same trials, so the same verdict-cache ledger
        assert tplanner.verdict_cache_stats() == jplanner.verdict_cache_stats()
    return tstate, tplanner, tsnap


def geometry_of(state, node):
    return {g.gpu_index: g.resources for g in state[node].gpus}


# ------------------------------------------------------------ sort

def test_sort_priority_then_largest_slice():
    small = port_pod(PodDesc("small", {mig("1g.10gb"): 1}))
    big = port_pod(PodDesc("big", {mig("7g.80gb"): 1}))
    vip = port_pod(PodDesc("vip", {mig("1g.10gb"): 1}, priority=100))
    assert [p.name for p in sort_candidate_pods([big, small, vip])] == ["vip", "big", "small"]


def test_sort_name_tiebreak():
    a, b = (port_pod(PodDesc(n, {mig("1g.10gb"): 1})) for n in "ab")
    assert [p.name for p in sort_candidate_pods([b, a])] == ["a", "b"]


def test_sort_aging_promotes_starved_small_pod(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    old = port_pod(PodDesc("old-small", {mig("1g.10gb"): 1}))
    fresh = port_pod(PodDesc("fresh-big", {mig("7g.80gb"): 1}))
    since = {old.namespaced_name: NOW - 8.5}
    assert [p.name for p in sort_candidate_pods([fresh, old], pending_since=since)] == [
        "old-small", "fresh-big"]
    assert [p.name for p in sort_candidate_pods([fresh, old], aging_per_second=0.0,
                                                pending_since=since)] == [
        "fresh-big", "old-small"]


def test_sort_first_consideration_is_not_aged():
    old = port_pod(PodDesc("old-small", {mig("1g.10gb"): 1}))
    fresh = port_pod(PodDesc("fresh-big", {mig("7g.80gb"): 1}))
    assert [p.name for p in sort_candidate_pods([old, fresh])] == ["fresh-big", "old-small"]


def test_sort_aging_never_crosses_priority(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    old = port_pod(PodDesc("old-small", {mig("1g.10gb"): 1}))
    vip = port_pod(PodDesc("vip", {mig("1g.10gb"): 1}, priority=1))
    since = {old.namespaced_name: NOW - 3600}
    assert [p.name for p in sort_candidate_pods([old, vip], pending_since=since)] == [
        "vip", "old-small"]


def test_sort_counts_mps_slices_by_gb_over_ten():
    # the port's measure (the reference counts a shared slice as 0 chips)
    pods = [port_pod(PodDesc(f"p{gb}", {mps(f"{gb}gb"): 1})) for gb in (10, 40, 5, 20)]
    assert [p.name for p in sort_candidate_pods(pods)] == ["p40", "p20", "p10", "p5"]


@pytest.mark.parametrize("seed", range(6))
def test_sort_matches_the_reference(tables, seed):
    rng = random.Random(900 + seed)
    pods = [PodDesc(f"p{i:02d}", {mig(rng.choice(MIG_PROFILES)): rng.randint(1, 2)},
                    ns=rng.choice(["a", "b"]), priority=rng.choice([0, 0, 1, 5]))
            for i in range(rng.randint(2, 25))]
    since = {p.key: NOW - rng.choice([0.0, 0.0, 2.0, 9.0]) for p in pods}
    got = [p.namespaced_name for p in sort_candidate_pods([port_pod(p) for p in pods],
                                                          pending_since=since)]
    want = [p.namespaced_name for p in jsort([ref_pod(p) for p in pods],
                                              pending_since=since)]
    assert got == want


# ------------------------------------------------------------ planner cases

FREE_4G = {0: {"4g.40gb": 1}}


@pytest.mark.parametrize("cache", [True, False])
class TestPlannerCases:
    """tests/partitioning/test_planner.py's TestPlanner, TestPlannerRegressions,
    TestPlannerSimulationFidelity and TestAgedRescue cases that this slice
    carries, each against the reference and with the reference's outcome."""

    def test_carves_virgin_node_for_pending_pod(self, tables, cache):
        state, _, snap = plan_both([NodeDesc("n1")], [PodDesc("p", {mig("4g.40gb"): 1})],
                                   cache=cache)
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb"), 0) >= 1
        assert placements(snap)["n1"] == ["p"]

    def test_no_lacking_returns_current_state(self, tables, cache):
        state, _, snap = plan_both([NodeDesc("n1", free={0: {"4g.40gb": 2}})],
                                   [PodDesc("p", {mig("4g.40gb"): 1})], cache=cache)
        assert geometry_of(state, "n1") == {0: {mig("4g.40gb"): 2}}
        assert placements(snap)["n1"] == []

    def test_reverts_when_no_pod_fits(self, tables, cache):
        state, planner, _ = plan_both([NodeDesc("n1")],
                                      [PodDesc("p", {mig("4g.40gb"): 1, "cpu": 999})],
                                      cache=cache)
        assert geometry_of(state, "n1") == {0: {}}
        assert "default/p" in planner.last_unserved

    def test_multiple_pods_packed_on_one_node(self, tables, cache):
        pods = [PodDesc(f"p{i}", {mig("1g.10gb"): 1}) for i in range(8)]
        state, _, snap = plan_both([NodeDesc("n1")], pods, cache=cache)
        assert geometry_of(state, "n1") == {0: {mig("1g.10gb"): 8}}
        assert len(placements(snap)["n1"]) == 8

    def test_spreads_over_two_nodes(self, tables, cache):
        pods = [PodDesc(f"p{i}", {mig("7g.80gb"): 1}) for i in range(2)]
        state, _, _ = plan_both([NodeDesc("n1"), NodeDesc("n2")], pods, cache=cache)
        for name in ("n1", "n2"):
            assert geometry_of(state, name) == {0: {mig("7g.80gb"): 1}}

    def test_high_priority_pod_wins_contention(self, tables, cache):
        pods = [PodDesc("low", {mig("7g.80gb"): 1}),
                PodDesc("high", {mig("7g.80gb"): 1}, priority=10)]
        _, planner, snap = plan_both([NodeDesc("n1")], pods, cache=cache)
        assert placements(snap)["n1"] == ["high"]
        assert list(planner.last_unserved) == ["default/low"]

    def test_used_slices_preserved(self, tables, cache):
        state, _, _ = plan_both([NodeDesc("n1", used=FREE_4G)],
                                [PodDesc("p", {mig("1g.10gb"): 2})], cache=cache)
        geometry = geometry_of(state, "n1")[0]
        assert geometry.get(mig("4g.40gb")) == 1 and geometry.get(mig("1g.10gb"), 0) >= 2

    def test_unschedulable_filter_blocks_placement(self, tables, cache):
        state, _, snap = plan_both([NodeDesc("n1")], [PodDesc("p", {mig("4g.40gb"): 1})],
                                   framework="reject_all", cache=cache)
        assert geometry_of(state, "n1") == {0: {}} and placements(snap)["n1"] == []

    def test_two_pods_sharing_one_free_slice_get_second_carved(self, tables, cache):
        pods = [PodDesc(f"p{i}", {mig("4g.40gb"): 1}) for i in range(2)]
        state, _, snap = plan_both([NodeDesc("n1", free=FREE_4G)], pods, cache=cache)
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb")) == 2
        assert placements(snap)["n1"] == ["p0", "p1"]

    def test_pod_wanting_more_than_net_delta_triggers_carve(self, tables, cache):
        state, _, snap = plan_both([NodeDesc("n1", free=FREE_4G)],
                                   [PodDesc("p", {mig("4g.40gb"): 2})], cache=cache)
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb")) == 2
        assert placements(snap)["n1"] == ["p"]

    def test_declines_carve_for_untolerated_pod(self, tables, cache):
        node = NodeDesc("n1", taints=[("maintenance", "", "NoSchedule")])
        state, _, snap = plan_both([node], [PodDesc("p", {mig("4g.40gb"): 1})],
                                   framework="vanilla", cache=cache)
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb"), 0) == 0
        assert placements(snap)["n1"] == []

    def test_carves_for_tolerated_pod(self, tables, cache):
        node = NodeDesc("n1", taints=[("maintenance", "", "NoSchedule")])
        pod = PodDesc("p", {mig("4g.40gb"): 1}, tolerations=[("maintenance", "Exists", "", "")])
        state, _, _ = plan_both([node], [pod], framework="vanilla", cache=cache)
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb"), 0) >= 1

    def test_declines_carve_for_cordoned_node(self, tables, cache):
        _, _, snap = plan_both([NodeDesc("n1", unschedulable=True)],
                               [PodDesc("p", {mig("4g.40gb"): 1})], framework="vanilla",
                               cache=cache)
        assert placements(snap)["n1"] == []

    def test_aged_small_pod_wins_contested_free_slice(self, tables, cache):
        node = NodeDesc("n1", free=FREE_4G, used=FREE_4G)
        pods = [PodDesc("starved", {mig("1g.10gb"): 1}, ns="ml"),
                PodDesc("fresh", {mig("4g.40gb"): 1}, ns="ml")]
        state, planner, snap = plan_both([node], pods, ages={"ml/starved": 10.0}, cache=cache)
        # placed once, on the carve of the free 4g.40gb; fresh, whose slice
        # that was, is told what it lacks (F1)
        assert placements(snap)["n1"].count("starved") == 1
        assert geometry_of(state, "n1")[0] == {mig("1g.10gb"): 2, mig("2g.20gb"): 1,
                                               mig("4g.40gb"): 1}
        assert planner.last_unserved == {"ml/fresh": (
            "no node can be re-carved to yield lacking slices (1x nvidia.com/mig-4g.40gb)")}

    def test_fresh_small_pod_does_not_trigger_rescue(self, tables, cache):
        node = NodeDesc("n1", free=FREE_4G, used=FREE_4G)
        pods = [PodDesc("small", {mig("1g.10gb"): 1}, ns="ml"),
                PodDesc("fresh", {mig("4g.40gb"): 1}, ns="ml")]
        _, _, snap = plan_both([node], pods, cache=cache)
        placed = placements(snap)["n1"]
        assert "fresh" in placed and "small" not in placed


def test_reference_places_the_rescued_pod_twice(tables):
    """Fault F1, pinned on the reference: its own planner places the
    aged-rescued pod twice and leaves fresh without a reason; the port
    places it once and gives fresh its reason."""
    node = NodeDesc("n1", free=FREE_4G, used=FREE_4G)
    pods = [PodDesc("starved", {mig("1g.10gb"): 1}, ns="ml"),
            PodDesc("fresh", {mig("4g.40gb"): 1}, ns="ml")]
    jsnap, tsnap = snapshots([node])
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = JPlanner(jframe), Planner(tframe)
    jplanner.plan(jsnap, [ref_pod(p) for p in pods], pending_ages={"ml/starved": 10.0})
    tplanner.plan(tsnap, [port_pod(p) for p in pods], pending_ages={"ml/starved": 10.0})
    assert placements(jsnap)["n1"].count("starved") == 2
    assert jplanner.last_unserved == {}
    assert placements(tsnap)["n1"].count("starved") == 1
    assert list(tplanner.last_unserved) == ["ml/fresh"]


# the random MIG cases in which the reference places a pod twice (F1)
F1_SEEDS = (1003, 1004, 1009, 1017, 1018, 1019, 1037, 1038, 1048)


@pytest.mark.parametrize("seed", F1_SEEDS)
def test_reference_double_placement_seeds(tables, seed):
    """On these seeds the reference's own planner places one pod twice;
    the port, planning the same case, places every pod once."""
    nodes, pods, ages = random_mig_case(random.Random(seed), tables)
    jsnap, tsnap = snapshots(nodes)
    jframe, tframe = frameworks("vanilla")
    JPlanner(jframe).plan(jsnap, [ref_pod(p) for p in pods], pending_ages=ages)
    tplanner = Planner(tframe)
    tpods = [port_pod(p) for p in pods]
    tplanner.plan(tsnap, tpods, pending_ages=ages)
    jplaced = [n for names in placements(jsnap).values() for n in names]
    assert len(jplaced) == len(set(jplaced)) + 1
    assert_plan_invariants(tplanner, tsnap, tpods)


def test_recreated_pod_starts_at_age_zero(tables, monkeypatch):
    """Fault F2: ml/starved is planned alone at t 0, then deleted and
    recreated under its name (a new uid) and planned at t 10 beside
    ml/fresh. Both sides see a new pod of age 0: n1's geometry is left
    alone and fresh takes the free 4g.40gb."""
    from nos_tpu.kube.store import KubeStore
    from nos_tpu_torch.kube.store import NodeStore

    node = NodeDesc("n1", free=FREE_4G, used=FREE_4G)
    starved = PodDesc("starved", {mig("1g.10gb"): 1}, ns="ml")
    fresh = PodDesc("fresh", {mig("4g.40gb"): 1}, ns="ml")
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    jframe, tframe = frameworks("basic")
    jplanner, tplanner = JPlanner(jframe), Planner(tframe, clock=lambda: clock[0])
    jstore, tstore = KubeStore(), NodeStore()
    for store, build in ((jstore, ref_pod), (tstore, port_pod)):
        store.create(build(starved))
    jsnap, tsnap = snapshots([node])
    jplanner.plan(jsnap, jstore.list("Pod"))
    tplanner.plan(tsnap, tstore.list("Pod"))
    clock[0] = 10.0
    old_uid = tstore.get("Pod", "starved", "ml").uid
    for store, build in ((jstore, ref_pod), (tstore, port_pod)):
        store.delete("Pod", "starved", "ml")
        store.create(build(starved))
        store.create(build(fresh))
    assert tstore.get("Pod", "starved", "ml").uid != old_uid
    jsnap, tsnap = snapshots([node])
    jstate = jplanner.plan(jsnap, jstore.list("Pod"))
    tstate = tplanner.plan(tsnap, tstore.list("Pod"))
    assert tplanner.last_pending_ages == {"ml/starved": 0.0, "ml/fresh": 0.0}
    assert port_state(tstate) == ref_state(jstate)
    assert geometry_of(tstate, "n1") == {0: {mig("4g.40gb"): 2}}
    assert placements(tsnap) == placements(jsnap) == {"n1": ["fresh", "run-n1-0-4g.40gb-0"]}
    assert tplanner.last_unserved == ref_unserved(jplanner.last_unserved)


def test_plain_gpu_request_is_never_placed(tables):
    # whole GPUs are not a MIG slice: nothing normalizes them (the
    # reference's plain-chip normalization has no counterpart)
    _, tsnap = snapshots([NodeDesc("n1", gpus=2)])
    planner = Planner(tfw.Framework(filter_plugins=tfw.vanilla_filter_plugins()))
    pod = port_pod(PodDesc("p", {"nvidia.com/gpu": 1}))
    state = planner.plan(tsnap, [pod])
    assert port_state(state) == {"n1": ()} and placements(tsnap)["n1"] == []
    assert planner.last_unserved == {}  # it lacks no slice this mode serves


# ------------------------------------------------------------ random clusters

def _gpu_state(rng, geometries):
    if rng.random() < 0.25:
        return {}, {}
    base = dict(rng.choice(geometries))
    used = {p: k for p, n in base.items() if (k := rng.randint(0, n))}
    rest = {p: n - used.get(p, 0) for p, n in base.items()}
    free = {p: k for p, n in rest.items() if n > 0 and (k := rng.randint(0, n))}
    return free, used


def random_mig_case(rng, geometries):
    nodes = []
    for i in range(rng.randint(1, 8)):
        desc = NodeDesc(f"n{i}", gpus=rng.randint(1, 3), labels={"pool": rng.choice("ab")})
        for gpu in range(desc.gpus):
            free, used = _gpu_state(rng, geometries)
            if free:
                desc.free[gpu] = free
            if used:
                desc.used[gpu] = used
        if rng.random() < 0.15:
            desc.taints = [("dedicated", "x", "NoSchedule")]
        desc.unschedulable = rng.random() < 0.08
        nodes.append(desc)
    pods, ages = [], {}
    for j in range(rng.randint(1, 30)):
        request = {mig(rng.choice(MIG_PROFILES)): 2 if rng.random() < 0.15 else 1}
        if rng.random() < 0.3:
            request["cpu"] = rng.randint(1, 4)
        pod = PodDesc(f"p{j:02d}", request, ns=rng.choice(["a", "b"]),
                      priority=rng.choice([0, 0, 0, 1, 5]))
        if rng.random() < 0.3:
            pod.tolerations = [("dedicated", "Equal", "x", "NoSchedule")]
        if rng.random() < 0.15:
            pod.selector = {"pool": rng.choice("ab")}
        if rng.random() < 0.25:
            ages[pod.key] = rng.choice([1.0, 3.0, 10.0])
        pods.append(pod)
    return nodes, pods, ages


@pytest.mark.parametrize("seed", range(50))
def test_plan_matches_the_reference_on_random_mig_clusters(tables, seed):
    rng = random.Random(1000 + seed)
    nodes, pods, ages = random_mig_case(rng, tables)
    for cache in (True, False):
        for futility in (True, False):
            plan_both(nodes, pods, framework="vanilla", ages=ages, cache=cache,
                      futility=futility)


MPS_PROFILES = ("5gb", "10gb", "20gb", "40gb")


@pytest.mark.parametrize("seed", range(20))
def test_plan_matches_the_reference_on_random_mps_clusters(mps_tables, seed):
    rng = random.Random(2000 + seed)
    nodes = []
    for i in range(rng.randint(1, 6)):
        desc = NodeDesc(f"s{i}", gpus=rng.randint(1, 3), mode="mps")
        for gpu in range(desc.gpus):
            budget = 80
            for target in (desc.used, desc.free):
                for p in rng.sample(MPS_PROFILES, rng.randint(0, 2)):
                    n = rng.randint(1, 2)
                    if int(p[:-2]) * n <= budget:
                        target.setdefault(gpu, {})[p] = n
                        budget -= int(p[:-2]) * n
        nodes.append(desc)
    n_pods = rng.randint(1, 30)
    priorities = rng.sample(range(100), n_pods)  # one order on both sides
    pods = [PodDesc(f"q{j:02d}", {mps(rng.choice(MPS_PROFILES)): 1}, priority=priorities[j])
            for j in range(n_pods)]
    for cache in (True, False):
        plan_both(nodes, pods, framework="vanilla", cache=cache)


# ------------------------------------------------------------ snapshot journal

def _compare_snapshots(jsnap, tsnap):
    assert nonzero(tsnap.free_slice_resources()) == translate_pool(jsnap.free_slice_resources())
    assert ({n: node.version for n, node in tsnap.get_nodes().items()}
            == {n: node.version for n, node in jsnap.get_nodes().items()})
    assert tsnap.state_version == jsnap.state_version
    assert tsnap.forked == jsnap.forked
    assert port_state(tsnap.partitioning_state()) == ref_state(jsnap.partitioning_state())
    assert placements(tsnap) == placements(jsnap)
    assert tsnap.get_candidate_nodes() == jsnap.get_candidate_nodes()


def _three_nodes():
    return [NodeDesc("a", gpus=2), NodeDesc("b", free={0: {"2g.20gb": 2}}),
            NodeDesc("c", gpus=2, used={1: {"7g.80gb": 1}}, free={0: {"1g.10gb": 1}})]


def test_nested_fork_carve_add_revert_commit(tables):
    jsnap, tsnap = snapshots(_three_nodes())
    jsnap.free_slice_resources(), tsnap.free_slice_resources()  # pools computed up front
    steps = [
        ("fork",), ("carve", "a", {mig("4g.40gb"): 2}),
        ("fork",), ("add", "a", PodDesc("x", {mig("4g.40gb"): 1})),
        ("add", "b", PodDesc("y", {mig("2g.20gb"): 1})),
        ("revert",), ("commit",),
    ]
    for step in steps:
        _apply(jsnap, tsnap, step)
        _compare_snapshots(jsnap, tsnap)
    # the carve survived, the placements did not
    assert port_state(tsnap.partitioning_state())["a"][0][1] == ((mig("4g.40gb"), 2),)
    assert placements(tsnap) == {"a": [], "b": [], "c": ["run-c-1-7g.80gb-0"]}


def _apply(jsnap, tsnap, step):
    op = step[0]
    if op == "fork":
        jsnap.fork(), tsnap.fork()
    elif op in ("commit", "revert"):
        assert getattr(tsnap, op)() == getattr(jsnap, op)()
    elif op == "carve":
        _, node, lacking = step
        assert tsnap.update_geometry_for(node, lacking) == jsnap.update_geometry_for(
            node, {to_ref_resource(k): v for k, v in lacking.items()})
    else:
        _, node, pod = step
        assert tsnap.add_pod(node, port_pod(pod)) == jsnap.add_pod(node, ref_pod(pod))


@pytest.mark.parametrize("seed", range(8))
def test_random_fork_sequences_match_the_reference(tables, seed):
    rng = random.Random(3000 + seed)
    jsnap, tsnap = snapshots(_three_nodes())
    if rng.random() < 0.5:
        jsnap.free_slice_resources(), tsnap.free_slice_resources()
    depth = 0
    for i in range(40):
        roll = rng.random()
        if roll < 0.2 and depth < 3:
            step, depth = ("fork",), depth + 1
        elif roll < 0.35 and depth:
            step, depth = (rng.choice(["commit", "revert"]),), depth - 1
        elif roll < 0.7:
            step = ("carve", rng.choice("abc"),
                    {mig(rng.choice(MIG_PROFILES)): rng.randint(1, 3)})
        else:
            step = ("add", rng.choice("abc"),
                    PodDesc(f"x{i}", {mig(rng.choice(MIG_PROFILES)): 1}))
        _apply(jsnap, tsnap, step)
        _compare_snapshots(jsnap, tsnap)


def test_fork_clones_only_the_touched_node(tables):
    _, tsnap = snapshots(_three_nodes())
    untouched = tsnap.get_nodes()["b"]
    tsnap.fork()
    tsnap.update_geometry_for("a", {mig("1g.10gb"): 1})
    assert tsnap.get_nodes()["b"] is untouched
    assert tsnap.revert() == 1
    with pytest.raises(RuntimeError):
        tsnap.revert()


def test_mutations_stamp_unique_versions_and_revert_restores_them(tables):
    _, tsnap = snapshots(_three_nodes())
    seen = set()
    tsnap.fork()
    assert tsnap.update_geometry_for("a", {mig("1g.10gb"): 1})
    seen.add(tsnap.get_nodes()["a"].version)
    tsnap.revert()
    assert tsnap.get_nodes()["a"].version == 0 and tsnap.state_version == 0
    tsnap.fork()
    assert tsnap.update_geometry_for("a", {mig("1g.10gb"): 1})
    version = tsnap.get_nodes()["a"].version
    assert version not in seen  # the clock never repeats, even across a revert
    tsnap.commit()
    assert tsnap.get_nodes()["a"].version == version


# ------------------------------------------------------------ tracker

@pytest.mark.parametrize("seed", range(6))
def test_tracker_matches_the_reference(tables, seed):
    rng = random.Random(4000 + seed)
    nodes, pods, _ = random_mig_case(rng, tables)
    jsnap, tsnap = snapshots(nodes)
    jpods, tpods = [ref_pod(p) for p in pods], [port_pod(p) for p in pods]
    jt, tt = JTracker(jsnap, jpods), SliceTracker(tsnap, tpods)
    assert tt.pods_with_lacking_slices() == jt.pods_with_lacking_slices()
    assert tt.lacking_totals() == translate_pool(jt.lacking_totals())
    for jp, tp in zip(jpods, tpods):
        assert tt.lacking_for(tp) == translate_pool(jt.lacking_for(jp))
        if rng.random() < 0.5:
            jt.remove(jp), tt.remove(tp)
            assert (tp in tt) == (jp in jt)
            assert tt.lacking_totals() == translate_pool(jt.lacking_totals())
    assert tt.empty == jt.empty


def test_tracker_shares_one_free_pool():
    _, tsnap = snapshots([NodeDesc("n1", free=FREE_4G)])
    pods = [port_pod(PodDesc(f"p{i}", {mig("4g.40gb"): 1})) for i in range(2)]
    tracker = SliceTracker(tsnap, pods)
    assert tracker.pods_with_lacking_slices() == ["default/p1"]
    assert tracker.lacking_totals() == {mig("4g.40gb"): 1}
    tracker.remove(pods[1])
    assert tracker.empty and tracker.lacking_totals() == {}


# ------------------------------------------------------------ verdict cache

def test_signature_is_an_equivalence_class():
    a = port_pod(PodDesc("a", {mig("1g.10gb"): 1}))
    b = port_pod(PodDesc("b", {mig("1g.10gb"): 1}))
    assert pod_signature(a) == pod_signature(b)
    for mutate in (lambda p: p.request.update(cpu=1), lambda p: setattr(p, "namespace", "x"),
                   lambda p: p.labels.update(app="y"), lambda p: setattr(p, "node", "n"),
                   lambda p: p.node_selector.update(pool="a"),
                   lambda p: p.tolerations.append(PodDesc("t").tolerations or
                                                  port_pod(PodDesc(
                                                      "t", tolerations=[("k", "Exists", "",
                                                                         "")])).tolerations[0])):
        c = port_pod(PodDesc("c", {mig("1g.10gb"): 1}))
        mutate(c)
        assert pod_signature(c) != pod_signature(a)


def test_cache_counts_hits_and_misses():
    cache = VerdictCache()
    key = ((), "n", 1)
    assert cache.get(key) is None
    cache.put(key, True)
    assert cache.get(key) is True and cache.get(key) is True
    assert cache.get(((), "n", 2)) is None  # another version: another entry
    assert cache.stats() == (2, 2, 0)


def test_a_plan_hits_the_cache_on_repeated_trials(tables):
    # eight identical pods tried on the same unchanged nodes: the first
    # trial of each (signature, node, version) misses, the rest hit
    nodes = [NodeDesc("full", used={0: {"7g.80gb": 1}}), NodeDesc("n1", free={0: {
        "1g.10gb": 1}})]
    pods = [PodDesc(f"p{i}", {mig("1g.10gb"): 1, "cpu": 100}) for i in range(8)]
    _, planner, _ = plan_both(nodes, pods, framework="vanilla", cache=True, futility=False)
    hits, misses, bypasses = planner.verdict_cache_stats()
    assert hits > 0 and bypasses == 0


# ------------------------------------------------------------ snapshot takers

def test_snapshot_taker_matches_the_reference(tables):
    descs = [
        NodeDesc("a", gpus=2, free={0: {"4g.40gb": 1}}, used={1: {"1g.10gb": 1}}),
        NodeDesc("in-flight", annotations={"nos.nebuly.com/spec-partitioning-plan": "2",
                                           "nos.nebuly.com/status-partitioning-plan": "1"}),
        NodeDesc("stale", free={0: {"1g.10gb": 1}}),
        NodeDesc("other", mode="mps"),
    ]
    bound = running_pods(descs) + [
        # bound to a profile the node reports no instance of: mid-change
        PodDesc("ghost", {mig("7g.80gb"): 1}, node="stale", phase="Running"),
        # bound since the last report: takes the free 4g.40gb
        PodDesc("fresh", {mig("4g.40gb"): 1}, node="a", phase="Pending")]
    jstate, tstate = JState(), ClusterState()
    for desc in descs:
        on = [p for p in bound if p.node == desc.name]
        jstate.update_node(ref_node(desc), [ref_pod(p) for p in on])
        tstate.update_node(port_node(desc), [port_pod(p) for p in on])
    jsnap = TpuSnapshotTaker().take_snapshot(jstate)
    tsnap = MigSnapshotTaker().take_snapshot(tstate)
    assert sorted(tsnap.get_nodes()) == sorted(jsnap.get_nodes()) == ["a", "in-flight", "stale"]
    for name, node in tsnap.get_nodes().items():
        jnode = jsnap.get_nodes()[name]
        assert node.frozen == jnode.frozen
        assert node.partitionable.consistent == jnode.partitionable.consistent
        assert sorted(p.name for p in node.pods) == sorted(p.metadata.name for p in jnode.pods)
    assert tsnap.get_candidate_nodes() == jsnap.get_candidate_nodes() == ["a"]
    assert nonzero(tsnap.free_slice_resources()) == translate_pool(
        jsnap.free_slice_resources())


# ------------------------------------------------------------ F3

def f3_nodes():
    """Two MPS nodes, each with one free 20 GB slice; s3 also has a GPU
    whose memory was never carved."""
    return [NodeDesc("s2", mode="mps", free={0: {"20gb": 1}}, used={0: {"20gb": 3}}),
            NodeDesc("s3", gpus=2, mode="mps", free={0: {"20gb": 1}}, used={0: {"20gb": 3}})]


def test_f3_port_carves_for_a_pod_split_free_slices_cover(mps_tables):
    """Fault F3: the free pool covers 2 x 20 GB, no node holds both. The
    reference's own planner leaves the pod unplaced with no reason and
    carves nothing; the port puts it back into the tracker, carves s3's
    uncarved GPU for it and places it there."""
    pod = PodDesc("f3", {mps("20gb"): 2}, ns="team-c")
    jsnap, tsnap = snapshots(f3_nodes())
    jframe, tframe = frameworks("vanilla")
    jplanner, tplanner = JPlanner(jframe), Planner(tframe)
    jstate = jplanner.plan(jsnap, [ref_pod(pod)])
    tstate = tplanner.plan(tsnap, [port_pod(pod)])
    assert all("f3" not in names for names in placements(jsnap).values())
    assert jplanner.last_unserved == {}
    assert ref_state(jstate) == port_state(snapshots(f3_nodes())[1].partitioning_state())
    assert "f3" in placements(tsnap)["s3"]
    assert geometry_of(tstate, "s3")[1] == {mps("20gb"): 1}
    assert tplanner.last_unserved == {}
    # with the same repair on the reference's side, the plans agree
    plan_both(f3_nodes(), [pod], framework="vanilla")


def test_f3_unplaceable_pod_lacks_its_whole_request(mps_tables):
    """Without memory to carve, the repaired pod is told it lacks its
    whole request, where the reference gave it no reason."""
    nodes = [NodeDesc(n, mode="mps", free={0: {"20gb": 1}}, used={0: {"20gb": 3}})
             for n in ("s2", "s3")]
    _, planner, _ = plan_both(nodes, [PodDesc("f3", {mps("20gb"): 2})], framework="vanilla")
    assert planner.last_unserved == {"default/f3": (
        "no node can be re-carved to yield lacking slices (2x nvidia.com/gpu-20gb)")}


# ------------------------------------------------------------ the gang pre-pass

def gang(name, gang_name, size, request=None, **kw):
    return PodDesc(name, dict(request or {mig("4g.40gb"): 1}), ns="team",
                   labels={"nos.nebuly.com/gang": gang_name,
                           "nos.nebuly.com/gang-size": str(size)}, **kw)


class TestPlannerGangFidelity:
    """tests/partitioning/test_planner.py's TestPlannerGangFidelity: a
    half-formable gang triggers no carve."""

    def test_half_formable_gang_triggers_no_carve(self, tables):
        state, planner, snap = plan_both([NodeDesc("n1")],
                                         [gang(f"m{i}", "trainer", 3) for i in range(2)])
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb"), 0) == 0
        assert placements(snap)["n1"] == []
        assert planner.last_unserved == {
            f"team/m{i}": "gang team/trainer cannot fully form; no slices are carved for "
                          "partial gangs" for i in range(2)}

    def test_fully_formable_gang_is_carved(self, tables):
        state, _, snap = plan_both([NodeDesc("n1")],
                                   [gang(f"m{i}", "trainer", 2) for i in range(2)])
        assert geometry_of(state, "n1")[0].get(mig("4g.40gb"), 0) >= 2
        assert len(placements(snap)["n1"]) == 2

    def test_gang_exclusion_leaves_other_pods_served(self, tables):
        pods = [gang(f"m{i}", "trainer", 5) for i in range(2)]
        pods.append(PodDesc("solo", {mig("4g.40gb"): 1}))
        _, _, snap = plan_both([NodeDesc("n1")], pods)
        assert placements(snap)["n1"] == ["solo"]

    def test_gang_counts_already_running_members(self, tables):
        running = gang("m0", "trainer", 2, node="n1", phase="Running")
        _, _, snap = plan_both([NodeDesc("n1", used={0: {"4g.40gb": 1}})],
                               [gang("m1", "trainer", 2)], running=[running])
        assert "m1" in placements(snap)["n1"]

    def test_gang_member_on_fully_carved_node_still_counts(self, tables):
        running = gang("m0", "trainer", 2, {mig("7g.80gb"): 1}, node="n1", phase="Running")
        nodes = [NodeDesc("n1", used={0: {"7g.80gb": 1}}), NodeDesc("n2")]
        jsnap, tsnap = snapshots(nodes, [running], generic=False)
        assert "n1" not in tsnap.get_candidate_nodes()  # the premise
        _, _, snap = plan_both(nodes, [gang("m1", "trainer", 2)], running=[running])
        assert placements(snap)["n2"] == ["m1"]


def _decorate(rng, pods, nodes, running):
    """Gangs, spread and anti-affinity terms on a random case, drawn from
    their own generator so the base case is the undecorated seed's."""
    from nos_tpu_torch.kube.store import PodAffinityTerm, TopologySpreadConstraint

    for desc in nodes:
        desc.labels["zone"] = rng.choice(["z1", "z2"])
        desc.labels["kubernetes.io/hostname"] = desc.name
    apps = ["web", "db"]
    for pod in pods + running:
        pod.labels["app"] = rng.choice(apps)
    for pod in running:
        if rng.random() < 0.2:
            pod.pod_anti_affinity = [PodAffinityTerm(
                topology_key=rng.choice(["zone", "kubernetes.io/hostname"]),
                match_labels={"app": rng.choice(apps)})]
        if rng.random() < 0.2:
            pod.labels.update({"nos.nebuly.com/gang": f"g{rng.randint(0, 2)}",
                               "nos.nebuly.com/gang-size": str(rng.randint(2, 4))})
            pod.ns = "a"
    sizes = {f"g{i}": rng.randint(1, 4) for i in range(3)}
    for pod in pods:
        roll = rng.random()
        if roll < 0.25:
            name = rng.choice(sorted(sizes))
            pod.ns = "a"
            pod.labels.update({"nos.nebuly.com/gang": name,
                               "nos.nebuly.com/gang-size": str(sizes[name])})
        elif roll < 0.4:
            pod.pod_anti_affinity = [PodAffinityTerm(
                topology_key=rng.choice(["zone", "kubernetes.io/hostname"]),
                match_labels={"app": pod.labels["app"]})]
        elif roll < 0.55:
            pod.spread = [TopologySpreadConstraint(
                topology_key=rng.choice(["zone", "kubernetes.io/hostname"]),
                max_skew=rng.choice([1, 2]), match_labels={"app": pod.labels["app"]})]


@pytest.mark.parametrize("seed", range(50))
def test_plan_with_gangs_and_terms_matches_the_reference_on_random_mig_clusters(tables, seed):
    """The 50 random MIG clusters, their pods given gangs, spread and
    anti-affinity terms and some running pods gangs and anti-affinity:
    plans, placements, reasons and the verdict-cache ledger with its
    bypasses agree, the cache on and off."""
    nodes, pods, ages = random_mig_case(random.Random(1000 + seed), tables)
    running = running_pods(nodes)
    _decorate(random.Random(11000 + seed), pods, nodes, running)
    for cache in (True, False):
        plan_both(nodes, pods, framework="vanilla", ages=ages, cache=cache, futility=False,
                  running=running)


@pytest.mark.parametrize("seed", range(20))
def test_plan_with_gangs_and_terms_matches_the_reference_on_random_mps_clusters(
        mps_tables, seed):
    rng = random.Random(12000 + seed)
    nodes = []
    for i in range(rng.randint(1, 6)):
        desc = NodeDesc(f"s{i}", gpus=rng.randint(1, 3), mode="mps")
        for gpu in range(desc.gpus):
            budget = 80
            for target in (desc.used, desc.free):
                for p in rng.sample(MPS_PROFILES, rng.randint(0, 2)):
                    n = rng.randint(1, 2)
                    if int(p[:-2]) * n <= budget:
                        target.setdefault(gpu, {})[p] = n
                        budget -= int(p[:-2]) * n
        nodes.append(desc)
    n_pods = rng.randint(1, 30)
    priorities = rng.sample(range(100), n_pods)
    pods = [PodDesc(f"q{j:02d}", {mps(rng.choice(MPS_PROFILES)): rng.choice([1, 1, 2])},
                    priority=priorities[j]) for j in range(n_pods)]
    running = running_pods(nodes)
    _decorate(rng, pods, nodes, running)
    for cache in (True, False):
        plan_both(nodes, pods, framework="vanilla", cache=cache, futility=False,
                  running=running)


def test_random_gang_cases_exclude_gangs_and_bypass_the_cache(tables):
    """The decorated cases are not all one outcome: some exclude a gang,
    some reuse the trial, and some trials bypass the cache."""
    excluded = bypassed = 0
    for seed in range(50):
        nodes, pods, ages = random_mig_case(random.Random(1000 + seed), tables)
        running = running_pods(nodes)
        _decorate(random.Random(11000 + seed), pods, nodes, running)
        _, planner, _ = plan_both(nodes, pods, framework="vanilla", ages=ages, futility=False,
                                  running=running)
        excluded += any("cannot fully form" in r for r in planner.last_unserved.values())
        bypassed += planner.verdict_cache_stats()[2] > 0
    assert excluded > 0 and bypassed > 0
