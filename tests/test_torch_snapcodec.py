"""The planner's warm state (``partitioning/core/snapcodec.py`` and the
planner's hand-offs) and the warm boot of the partitioner controller.

The reference's cases (tests/partitioning/test_snapcodec.py:80-202) on
translated worlds: a restart that adopts the saved memos plans what a
cold planner plans (and what the reference plans), with fewer futility
trials; a codec version bump, another slice codec, a corrupt file and an
absent one each give a clean cold path; a geometry drift on one node
leaves only that node unmatched; the save is rate-limited on the codec's
clock and atomic. The port's own: F4's refusals are part of a node's
signature, so two nodes equal but for one refusal sign apart and neither
adopts the other's entries; only entries keyed at a node's observed
version are exported; and ``SimCluster``'s restart from the file wave 1
left plans what a cold controller plans.
"""
import json
import time

import pytest

from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.kube.store import Pod, PodPhase
from nos_tpu_torch.partitioning.core import ClusterState, Planner
from nos_tpu_torch.partitioning.core.partition_state import partitioning_state_to_dict
from nos_tpu_torch.partitioning.core.snapcodec import (
    SNAPSHOT_CODEC_VERSION,
    WarmStateCodec,
    node_state_signature,
)
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler import new_framework
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from tests.test_torch_planner import NOW, RefPlanner, frameworks, snapshots
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


def world(n=6, carve_first=6):
    """n one-GPU nodes, the first ``carve_first`` pinned by a used 4g.40gb
    beside two free 1g.10gb (no 7g.80gb can be carved there: every such
    trial is futile), the rest virgin."""
    nodes = []
    for i in range(n):
        desc = NodeDesc(f"n{i}")
        if i < carve_first:
            desc.free, desc.used = {0: {"1g.10gb": 2}}, {0: {"4g.40gb": 1}}
        nodes.append(desc)
    return nodes


# two whole GPUs in one pod: no one-GPU node serves it, and the carve
# toward it is futile on every carved node
BIG = PodDesc("big", {mig("7g.80gb"): 2})
OK = PodDesc("ok", {mig("4g.40gb"): 1})


def state_bytes(state):
    return json.dumps(partitioning_state_to_dict(state), sort_keys=True)


def basic():
    return frameworks("basic")[1]


def plan(snapshot, pods, planner=None, dirty=None):
    planner = planner or Planner(basic())
    return planner, planner.plan(snapshot, [port_pod(p) for p in pods], pending_ages={},
                                 dirty=dirty)


def saved(path, nodes, pods):
    """Plan once, save; (codec, desired, planner)."""
    _, snapshot = snapshots(nodes)
    planner, desired = plan(snapshot, pods)
    codec = WarmStateCodec(str(path))
    assert codec.save(snapshot, planner, force=True)
    return codec, desired, planner


# ------------------------------------------------------------ round trip

def test_warm_boot_plans_what_a_cold_planner_plans_with_fewer_trials(tables, tmp_path):
    path = tmp_path / "warm.json"
    nodes = world(6, carve_first=4)
    _, cold, cold_planner = saved(path, nodes, [BIG])
    _, snapshot = snapshots(nodes)
    planner = Planner(basic())
    report = WarmStateCodec(str(path)).adopt(snapshot, planner)
    assert report.matched == 6 and report.unmatched == set() and report.adopted_entries > 0
    assert report.outcome() == "adopted"
    _, warm = plan(snapshot, [BIG], planner, dirty=set(report.unmatched))
    assert planner.last_plan_mode == "incremental"
    assert state_bytes(warm) == state_bytes(cold)
    # the adopted proofs fired instead of being proved again
    assert planner._futility_hits > cold_planner._futility_hits
    # and the plan is the reference's
    jsnap, _ = snapshots(nodes)
    jstate = RefPlanner(frameworks("basic")[0]).plan(jsnap, [ref_pod(BIG)], pending_ages={})
    assert port_state(warm) == ref_state(jstate)


def test_save_is_rate_limited_on_its_clock_and_atomic(tables, tmp_path):
    path = tmp_path / "warm.json"
    _, snapshot = snapshots(world(2))
    planner, _ = plan(snapshot, [BIG, OK])
    now = [1000.0]
    codec = WarmStateCodec(str(path), save_interval_seconds=3600.0, clock=lambda: now[0])
    assert codec.due()  # the first save is always due
    assert codec.save(snapshot, planner)
    now[0] = 1001.0
    assert not codec.save(snapshot, planner) and not codec.due()
    assert codec.due(now=5000.0)
    now[0] = 5000.0
    assert codec.save(snapshot, planner)
    assert [p.name for p in tmp_path.iterdir()] == ["warm.json"]


# ------------------------------------------------------------ distrust → cold

def test_a_codec_version_bump_is_a_clean_cold_path(tables, tmp_path):
    path = tmp_path / "warm.json"
    saved(path, world(), [BIG, OK])
    doc = json.loads(path.read_text())
    doc["codec_version"] = SNAPSHOT_CODEC_VERSION + 1
    path.write_text(json.dumps(doc))
    _, snapshot = snapshots(world())
    planner = Planner(basic())
    codec = WarmStateCodec(str(path))
    assert codec.load(type(snapshot.codec).__name__) is None
    report = codec.adopt(snapshot, planner)
    assert report.matched == 0 and report.unmatched == set(snapshot.get_nodes())
    assert report.outcome() == "cold"
    _, desired = plan(snapshot, [BIG, OK], planner)
    _, fresh_snapshot = snapshots(world())
    _, fresh = plan(fresh_snapshot, [BIG, OK])
    assert state_bytes(desired) == state_bytes(fresh)


def test_another_slice_codec_is_cold(tables, tmp_path):
    path = tmp_path / "warm.json"
    saved(path, world(), [BIG])
    assert WarmStateCodec(str(path)).load("MpsSliceCodec") is None
    assert WarmStateCodec(str(path)).load("MigSliceCodec") is not None


@pytest.mark.parametrize("content", [None, "{not json", "[1, 2]", '{"codec_version": 1}'])
def test_a_corrupt_or_absent_file_is_cold(tables, tmp_path, content):
    path = tmp_path / "warm.json"
    if content is not None:
        path.write_text(content)
    _, snapshot = snapshots(world(2))
    report = WarmStateCodec(str(path)).adopt(snapshot, Planner(basic()))
    assert report.matched == 0 and report.unmatched == set(snapshot.get_nodes())


def test_geometry_drift_leaves_only_that_node_unmatched(tables, tmp_path):
    path = tmp_path / "warm.json"
    saved(path, world(6, carve_first=0), [BIG, OK])
    drifted = world(6, carve_first=1)  # n0 comes back carved
    _, snapshot = snapshots(drifted)
    planner = Planner(basic())
    report = WarmStateCodec(str(path)).adopt(snapshot, planner)
    assert report.unmatched == {"n0"} and report.matched == 5
    assert report.outcome() == "partial"
    _, warm = plan(snapshot, [BIG, OK], planner, dirty=set(report.unmatched))
    _, fresh_snapshot = snapshots(world(6, carve_first=1))
    _, fresh = plan(fresh_snapshot, [BIG, OK])
    assert state_bytes(warm) == state_bytes(fresh)


def test_the_signature_covers_the_planner_inputs(tables):
    def sig(mutate=None):
        node = port_node(NodeDesc("n"))
        if mutate:
            mutate(node)
        state = ClusterState()
        state.update_node(node, [])
        return node_state_signature(MigSnapshotTaker().take_snapshot(state).get_nodes()["n"])

    base = sig()
    assert sig() == base  # the same whatever the objects
    assert sig(lambda n: n.labels.update({"x": "y"})) != base
    assert sig(lambda n: n.allocatable.update({"cpu": 99})) != base
    assert sig(lambda n: setattr(n, "unschedulable", True)) != base
    assert sig(lambda n: n.annotations.update(tannot.status_from_devices(
        {0: {"1g.10gb": 2}}, {0: {"4g.40gb": 1}}))) != base


# ------------------------------------------------------------ F4's refusals

def _refusing(name, refuse):
    """A one-GPU node reporting a used 1g.10gb and three free 2g.20gb;
    with ``refuse``, its agent acknowledged a plan of 4g.40gb it could not
    create (F4)."""
    annotations = tannot.status_from_devices({0: {"2g.20gb": 3}}, {0: {"1g.10gb": 1}})
    if refuse:
        annotations.update(tannot.spec_from_geometries(
            {0: {"1g.10gb": 1, "2g.20gb": 1, "4g.40gb": 1}}))
        annotations.update({tannot.SPEC_PARTITIONING_PLAN: "7",
                            tannot.STATUS_PARTITIONING_PLAN: "7"})
    return port_node(NodeDesc(name, annotations=annotations))


def _snapshot_of(node):
    held = Pod("held", "default", node=node.name, phase=PodPhase.RUNNING,
               request={mig("1g.10gb"): 1}, uid="uid-held")
    state = ClusterState()
    state.update_node(node, [held])
    return MigSnapshotTaker().take_snapshot(state)


def test_refusals_are_part_of_the_signature(tables, tmp_path):
    """Two states equal but for one refusal sign apart, and a saved
    entry of one is adopted by neither the other nor, the other way."""
    refusing, plain = _snapshot_of(_refusing("m0", True)), _snapshot_of(_refusing("m0", False))
    assert refusing.get_nodes()["m0"].partitionable.gpus[0].refused
    assert not plain.get_nodes()["m0"].partitionable.gpus[0].refused
    assert node_state_signature(refusing.get_nodes()["m0"]) != node_state_signature(
        plain.get_nodes()["m0"])
    pod = Pod("p", "default", request={mig("4g.40gb"): 1})
    for saved_from, restarted in ((refusing, _refusing("m0", False)),
                                  (plain, _refusing("m0", True))):
        path = tmp_path / f"warm-{id(saved_from)}.json"
        planner = Planner(new_framework())
        planner.plan(saved_from, [pod], pending_ages={})
        assert WarmStateCodec(str(path)).save(saved_from, planner, force=True)
        report = WarmStateCodec(str(path)).adopt(_snapshot_of(restarted), Planner(new_framework()))
        assert report.unmatched == {"m0"} and report.adopted_entries == 0
        # the same state adopts
        again = WarmStateCodec(str(path)).adopt(saved_from, Planner(new_framework()))
        assert again.matched == 1


# ------------------------------------------------------------ the planner's hand-offs

def test_export_keeps_only_entries_at_observed_versions(tables):
    _, snapshot = snapshots(world(4, carve_first=2))
    planner, _ = plan(snapshot, [BIG, OK], dirty=set(snapshot.get_nodes()))
    exported = planner.export_warm_state(snapshot)
    versions = {name: node.version for name, node in snapshot.get_nodes().items()}
    in_cache = {k[0] for k in planner._futility_cache if versions[k[0]] == k[1]}
    assert set(n for n, e in exported.items() if e["futility"]) == in_cache
    # entries keyed at a trial's versions are left out
    stale = [k for k in planner._verdict_cache.entries if versions[k[1]] != k[2]]
    total = sum(len(e["verdicts"]) for e in exported.values())
    assert total == len(planner._verdict_cache.entries) - len(stale)
    # they round-trip through JSON and re-key at the live versions
    fresh = Planner(basic())
    adopted = fresh.adopt_warm_state(snapshot, json.loads(json.dumps(exported)))
    assert adopted == total + sum(len(e["futility"]) for e in exported.values())
    assert set(fresh._verdict_cache.entries) <= set(planner._verdict_cache.entries)


def test_adopt_pending_seen_keeps_the_earlier_sighting():
    a, b = Planner(basic()), Planner(basic())
    a._pending_seen = {("ns/p", "u1"): (5.0, 9.0), ("ns/q", "u2"): (1.0, 2.0)}
    b._pending_seen = {("ns/p", "u1"): (3.0, 4.0)}
    b.adopt_pending_seen(a)
    assert b._pending_seen == {("ns/p", "u1"): (3.0, 4.0), ("ns/q", "u2"): (1.0, 2.0)}


# ------------------------------------------------------------ the controller's restart

class _Recording:
    """An actuator that records the plan and writes nothing."""

    def __init__(self):
        self.plans = []

    def apply(self, current, plan):
        self.plans.append(plan)
        return 0


def _restarted(cluster, path):
    """A fresh MIG controller on the cluster's store, planning through a
    recording actuator: with ``path`` warm, else cold."""
    from nos_tpu_torch.controllers.partitioner import PartitionerController, build_sim_framework
    from nos_tpu_torch.gpu.node import PARTITIONING_MIG
    from nos_tpu_torch.partitioning.core.codec import is_mig_resource

    actuator = _Recording()
    controller = PartitionerController(
        cluster.store, ClusterState(), MigSnapshotTaker(),
        Planner(build_sim_framework(cluster.store), clock=cluster.clock), actuator,
        PARTITIONING_MIG, is_mig_resource, clock=cluster.clock, pool_sharding=True,
        warm_state_path=path)
    controller.sync()
    controller.process_pending_pods()
    return controller, actuator.plans[0]


@pytest.mark.parametrize("sharded", [False, True])
def test_a_restart_adopts_the_saved_state_and_plans_as_a_cold_start(tmp_path, sharded):
    cluster = SimCluster(pool_sharding=sharded, warm_state_path=str(tmp_path),
                         warm_state_save_interval_seconds=0.0)
    for i in range(4):
        cluster.add_mig_node(f"n{i}", gpus=2, pool="pool-a" if i < 2 else "pool-b")
    # a pool's 4 GPUs: three 7g.80gb pods and five 1g.10gb sharing the
    # fourth; then one more 7g.80gb waits, its carve futile on the node of
    # the shared GPU
    for wave in (["7g.80gb"] * 3 + ["1g.10gb"] * 5, ["7g.80gb"]):
        for pool in ("pool-a", "pool-b"):
            for profile in wave:
                cluster.store.create(Pod(f"{pool}-{cluster.steps}-{len(cluster.store.list())}",
                                         "default", request={mig(profile): 1},
                                         node_selector={NODEPOOL_LABEL: pool}))
        assert cluster.run_until_idle(300)
    assert cluster.mig.fetch_pending_pods()  # the restart has pods to plan for
    path = str(tmp_path / "warm-state-mig.json")
    warm, warm_plan = _restarted(cluster, path)
    cold, cold_plan = _restarted(cluster, "")
    assert warm.last_warm_boot["outcome"] in ("adopted", "partial")
    assert warm.last_warm_boot["adopted_entries"] > 0 and cold.last_warm_boot is None
    assert state_bytes(warm_plan.desired_state) == state_bytes(cold_plan.desired_state)
    assert warm.last_unserved == cold.last_unserved
