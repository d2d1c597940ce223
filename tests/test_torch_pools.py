"""Pool-sharded planning (``partitioning/core/pools.py`` and the
``PoolShardedMaintainer``) against nos_tpu's.

On the translated clusters of tests/torch_planner_cases.py (a v5e board
↔ an H100, 1x1 / 1x2 / 2x2 / 2x4 ↔ 1g.10gb / 2g.20gb / 4g.40gb /
7g.80gb, one allowed-geometry table, one monotonic instant), with the
node-pool label ``cloud.google.com/gke-nodepool`` on both sides:

- ``partition_pools`` equals the reference's (pools, node → pool, pod →
  pool, merged seeds, whether it degraded to the mega pool; the reasons
  are worded alike but for the anti-affinity one) on the reference's
  cases of tests/partitioning/test_pools.py:114-262 and on 20 random
  clusters of 3–4 pools with selector-pinned pods;
- on those 20 clusters, and on 8 more without free instances (where the
  draw always decomposes), each pool's plan (serial, explicit ages) equals
  the reference's (the reference as ``RefPlanner``: F1 and F3
  repaired), state, unserved reasons and placements, and the merged
  plans agree; ``draw_decomposes`` agrees, and where it holds the port's
  sharded plan equals its unsharded plan byte for byte exactly where the
  reference's does. The reference says the two are then always equal; they
  are not (ROADMAP.md, fault F7: the sharded path carves toward each
  pool's lacking totals, the unsharded toward the cluster's, so a GPU can
  take another geometry though every pod lacks the same), on its side as
  on the port's: 7 of the 8 clusters without free instances differ. Two
  pools each with pods pinned, or one pool, are equal;
- ``check_merge_invariants`` flags what the reference's does on its
  failure cases (``test_pools.py:288-413``), capacity counted in memory
  slices (a 2x4 board's 8 chips ↔ an H100's 8 slices);
- the maintainer keeps, refreshes and rebuilds the pool snapshots as the
  reference's does (``test_pools.py:458-539``).

The MPS capacity (GB / 10 a GPU) has no reference counterpart (the
reference counts a shared slice as 0 chips) and is tested on the port
alone.
"""
import json
import random
import time

import pytest

from nos_tpu.partitioning.core import pools as jpools
from nos_tpu.partitioning.core.partition_state import BoardPartitioning
from nos_tpu.partitioning.core.partition_state import NodePartitioning as JNodePartitioning
from nos_tpu.partitioning.core.partition_state import (
    partitioning_state_to_dict as jstate_to_dict,
)
from nos_tpu_torch.controllers.partitioner.incremental import PoolShardedMaintainer
from nos_tpu_torch.kube.store import NodeStore, PodAffinityTerm, PodPhase
from nos_tpu_torch.kube.store import NodeSelectorRequirement, NodeSelectorTerm
from nos_tpu_torch.partitioning.core import ClusterState, Planner, sort_candidate_pods
from nos_tpu_torch.partitioning.core import pools as tpools
from nos_tpu_torch.partitioning.core.partition_state import (
    GpuPartitioning,
    NodePartitioning,
    partitioning_state_to_dict,
)
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from tests.test_torch_incremental import _ref_store_and_taker
from tests.test_torch_planner import (
    NOW,
    RefPlanner,
    _gpu_state,
    expected_unserved,
    frameworks,
    placements,
    snapshots,
)
from tests.torch_planner_cases import (
    MIG_PROFILES,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    port_state,
    ref_node,
    ref_pod,
    ref_state,
    same_tables,
)
from tests.torch_quota_cases import GB, QuotaDesc, port_quota, ref_quota


def mig(profile):
    return f"nvidia.com/mig-{profile}"


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    with same_tables() as geometries:
        yield geometries


CARVED = ({0: {"1g.10gb": 2}}, {0: {"4g.40gb": 1}})  # free, used


def pool_node(name, pool=None, carved=False, gpus=1):
    desc = NodeDesc(name, gpus=gpus, labels={NODEPOOL_LABEL: pool} if pool else {})
    if carved:
        desc.free, desc.used = ({g: dict(p) for g, p in c.items()} for c in CARVED)
    return desc


def two_pool_world():
    return [pool_node("a0", "pool-a"), pool_node("a1", "pool-a", carved=True),
            pool_node("b0", "pool-b"), pool_node("b1", "pool-b", carved=True)]


def pinned(name, profile, pool, **kw):
    return PodDesc(name, {mig(profile): 1}, selector={NODEPOOL_LABEL: pool}, **kw)


def gang(desc, key="g", size=2):
    desc.labels.update({GANG_NAME_LABEL: key, GANG_SIZE_LABEL: str(size)})
    return desc


# the reference's reasons worded as the port's
REASONS = {"placed pods carry required anti-affinity (symmetric terms)":
           "placed pods carry required anti-affinity"}


def partitions(nodes, pods, quotas=(), running=()):
    """(port, reference) partitions of one translated world, asserted
    equal."""
    jsnap, tsnap = snapshots(nodes, running)
    jpart = jpools.partition_pools(jsnap, [ref_pod(p) for p in pods],
                                   quotas=[ref_quota(q) for q in quotas])
    tpart = tpools.partition_pools(tsnap, [port_pod(p) for p in pods],
                                   quotas=[port_quota(q) for q in quotas])
    assert tpart.pools == jpart.pools
    assert tpart.node_pool == jpart.node_pool
    assert tpart.pod_pool == jpart.pod_pool
    assert tpart.merged_from == jpart.merged_from
    assert tpart.single_pool_reason == REASONS.get(jpart.single_pool_reason,
                                                   jpart.single_pool_reason)
    return tpart, jpart


# ------------------------------------------------------------ partition_pools

def test_selector_pinned_pods_keep_pools_apart(tables):
    part, _ = partitions(two_pool_world(), [pinned("pa", "4g.40gb", "pool-a"),
                                            pinned("pb", "4g.40gb", "pool-b")])
    assert part.pools == ("pool-a", "pool-b") and not part.single_pool_reason
    assert part.pod_pool == {"default/pa": "pool-a", "default/pb": "pool-b"}


def test_unpinned_pod_connects_every_pool(tables):
    part, _ = partitions(two_pool_world(), [PodDesc("free", {mig("4g.40gb"): 1})])
    assert part.pools == ("pool-a",)
    assert part.merged_from == {"pool-a": ("pool-a", "pool-b")}


def test_gang_spanning_two_pools_forces_merge(tables):
    members = [gang(pinned(f"g{i}", "4g.40gb", pool)) for i, pool in
               enumerate(["pool-a", "pool-b"])]
    part, _ = partitions(two_pool_world(), members)
    assert part.pools == ("pool-a",)


def test_gang_bound_member_pins_pending_member_to_its_pool(tables):
    nodes = [pool_node("a0", "pool-a"), pool_node("b0", "pool-b", carved=True)]
    bound = gang(PodDesc("g-bound", {mig("4g.40gb"): 1}, node="b0", phase="Running"))
    part, _ = partitions(nodes, [gang(pinned("g-pend", "4g.40gb", "pool-a"))], running=[bound])
    assert part.pools == ("pool-a",) and part.node_pool["b0"] == "pool-a"


def test_required_node_affinity_degrades_to_mega_pool(tables):
    pod = PodDesc("aff", {mig("4g.40gb"): 1}, node_affinity=[NodeSelectorTerm(
        [NodeSelectorRequirement("pool", "In", ["gold"])])])
    part, _ = partitions(two_pool_world(), [pod])
    assert part.pools == (tpools.MEGA_POOL,)
    assert "required node affinity" in part.single_pool_reason


def test_pod_affinity_terms_degrade_to_mega_pool(tables):
    pod = pinned("aff", "4g.40gb", "pool-a", pod_anti_affinity=[PodAffinityTerm(
        topology_key="kubernetes.io/hostname", match_labels={"app": "x"})])
    part, _ = partitions(two_pool_world(), [pod])
    assert part.pools == (tpools.MEGA_POOL,)


def test_placed_anti_affinity_degrades_to_mega_pool(tables):
    placed = PodDesc("anti", {mig("1g.10gb"): 1}, node="a1", phase="Running",
                     pod_anti_affinity=[PodAffinityTerm(topology_key="kubernetes.io/hostname",
                                                        match_labels={"app": "x"})])
    part, _ = partitions(two_pool_world(), [pinned("pa", "4g.40gb", "pool-a")],
                         running=[placed])
    assert part.pools == (tpools.MEGA_POOL,)


def test_borrowing_quota_couples_namespaces(tables):
    pods = [pinned("pa", "4g.40gb", "pool-a"), pinned("pb", "4g.40gb", "pool-b")]
    part, _ = partitions(two_pool_world(), pods,
                         quotas=[QuotaDesc("default", min={GB: 40}, max={GB: 80}, name="q")])
    assert part.pools == ("pool-a",)
    part, _ = partitions(two_pool_world(), pods,
                         quotas=[QuotaDesc("default", min={GB: 80}, max={GB: 80}, name="q")])
    assert part.pools == ("pool-a", "pool-b")


def test_unlabelled_nodes_form_the_default_pool(tables):
    part, _ = partitions([pool_node("n0"), pool_node("n1", "pool-b")],
                         [pinned("pb", "4g.40gb", "pool-b")])
    assert part.pools == ("default", "pool-b") and part.node_pool["n0"] == "default"


def test_a_selector_no_pool_satisfies_routes_to_the_first_pool(tables):
    part, _ = partitions(two_pool_world(), [pinned("x", "4g.40gb", "pool-z")])
    assert part.pod_pool == {"default/x": "pool-a"} and part.pools == ("pool-a", "pool-b")


def test_a_composite_borrowing_quota_couples_all_its_namespaces(tables):
    """Port only: the reference couples a composite quota's own namespace."""
    _, tsnap = snapshots(two_pool_world())
    pods = [port_pod(pinned("pa", "4g.40gb", "pool-a", ns="t1")),
            port_pod(pinned("pb", "4g.40gb", "pool-b", ns="t2"))]
    quota = port_quota(QuotaDesc("admin", min={GB: 40}, max={GB: 80}, name="c",
                                 namespaces=["t1", "t2"]))
    assert tpools.partition_pools(tsnap, pods, quotas=[quota]).pools == ("pool-a",)
    assert tpools.partition_pools(tsnap, pods).pools == ("pool-a", "pool-b")


# ------------------------------------------------------------ sharded plans

def _snap_and_plan(planner_cls, framework, snapshot, pods, ages):
    planner = planner_cls(framework)
    return planner, planner.plan(snapshot, pods, pending_ages=dict(ages))


def random_pool_case(rng, geometries, free_slices=True):
    """3–4 pools of random MIG nodes and selector-pinned pods; without
    ``free_slices`` no GPU holds a free instance, so every pod lacks its
    whole request from any pool and the draw decomposes."""
    pools = [f"pool-{c}" for c in "abcd"[:rng.randint(3, 4)]]
    nodes = []
    for i in range(rng.randint(4, 9)):
        desc = NodeDesc(f"n{i}", gpus=rng.randint(1, 2),
                        labels={NODEPOOL_LABEL: pools[i % len(pools)]})
        for g in range(desc.gpus):
            free, used = _gpu_state(rng, geometries)
            if free and free_slices:
                desc.free[g] = free
            if used:
                desc.used[g] = used
        nodes.append(desc)
    pods, ages = [], {}
    for j in range(rng.randint(4, 18)):
        pod = pinned(f"p{j:02d}", rng.choice(MIG_PROFILES), rng.choice(pools),
                     priority=rng.choice([0, 0, 1, 5]))
        if rng.random() < 0.3:
            ages[pod.key] = rng.choice([1.0, 3.0, 10.0])
        pods.append(pod)
    if rng.random() < 0.5:
        pool = rng.choice(pools)
        pods += [gang(pinned(f"gm{k}", "4g.40gb", pool), key="gm") for k in range(2)]
    return nodes, pods, ages


def _bytes(state_dict):
    return json.dumps(state_dict, sort_keys=True)


@pytest.mark.parametrize("seed,free_slices", [(s, True) for s in range(20)]
                         + [(s, False) for s in range(8)])
def test_sharded_plans_match_the_reference_on_random_pool_clusters(tables, seed, free_slices):
    nodes, pods, ages = random_pool_case(random.Random(3000 + seed), tables, free_slices)
    jsnap, tsnap = snapshots(nodes)
    jpods, tpods = [ref_pod(p) for p in pods], [port_pod(p) for p in pods]
    tpart = tpools.partition_pools(tsnap, tpods)
    jpart = jpools.partition_pools(jsnap, jpods)
    assert (tpart.pools, tpart.node_pool, tpart.pod_pool) == (jpart.pools, jpart.node_pool,
                                                              jpart.pod_pool)
    since = {p.key: NOW - ages.get(p.key, 0.0) for p in pods}
    order = [p.namespaced_name for p in sort_candidate_pods(tpods, pending_since=since, now=NOW)]
    by_name = {p.namespaced_name: p for p in jpods}
    decomposes = tpools.draw_decomposes(tsnap, tpart, sort_candidate_pods(
        tpods, pending_since=since, now=NOW))
    assert decomposes == jpools.draw_decomposes(jsnap, jpart, [by_name[k] for k in order])
    assert decomposes or free_slices
    jsnaps, tsnaps = jpools.split_snapshot(jsnap, jpart), tpools.split_snapshot(tsnap, tpart)
    jpending, tpending = jpools.split_pending(jpods, jpart), tpools.split_pending(tpods, tpart)
    jcur, tcur, jdes, tdes = {}, {}, {}, {}
    for pool in tpart.pools:
        jframe, tframe = frameworks("basic")
        jcur[pool] = jsnaps[pool].partitioning_state()
        tcur[pool] = tsnaps[pool].partitioning_state()
        jplanner, jdes[pool] = _snap_and_plan(RefPlanner, jframe, jsnaps[pool], jpending[pool],
                                              ages)
        tplanner, tdes[pool] = _snap_and_plan(Planner, tframe, tsnaps[pool], tpending[pool],
                                              ages)
        assert port_state(tdes[pool]) == ref_state(jdes[pool]), pool
        assert tplanner.last_unserved == expected_unserved(jplanner), pool
        assert placements(tsnaps[pool]) == placements(jsnaps[pool]), pool
    tmerged, jmerged = tpools.merge_pool_states(tdes), jpools.merge_pool_states(jdes)
    assert port_state(tmerged) == ref_state(jmerged)
    assert tpools.check_merge_invariants(tpart, tcur, tdes, tpools.node_capacities(
        tsnaps.values())) == []
    assert jpools.check_merge_invariants(jpart, jcur, jdes, jpools.node_capacities(
        jsnaps.values())) == []
    if decomposes:
        jframe, tframe = frameworks("basic")
        junsnap, tunsnap = snapshots(nodes)
        _, jfull = _snap_and_plan(RefPlanner, jframe, junsnap, [ref_pod(p) for p in pods], ages)
        _, tfull = _snap_and_plan(Planner, tframe, tunsnap, [port_pod(p) for p in pods], ages)
        assert port_state(tfull) == ref_state(jfull)
        # F7: the reference's sharded plan need not equal its unsharded one
        # where the draw decomposes (pool-local carve targets); the port's
        # is equal exactly where the reference's is
        assert (_bytes(partitioning_state_to_dict(tmerged))
                == _bytes(partitioning_state_to_dict(tfull))) == (
            _bytes(jstate_to_dict(jmerged)) == _bytes(jstate_to_dict(jfull)))


def test_pool_independent_inputs_are_byte_identical(tables):
    pods = [pinned("pa0", "4g.40gb", "pool-a"), pinned("pa1", "1g.10gb", "pool-a"),
            pinned("pb0", "4g.40gb", "pool-b")]
    _, tsnap = snapshots(two_pool_world())
    tpods = [port_pod(p) for p in pods]
    part = tpools.partition_pools(tsnap, tpods)
    assert len(part.pools) == 2 and tpools.draw_decomposes(tsnap, part, tpods)
    snaps, pending = tpools.split_snapshot(tsnap, part), tpools.split_pending(tpods, part)
    frame = frameworks("basic")[1]
    sharded = tpools.merge_pool_states({pool: Planner(frame).plan(snaps[pool], pending[pool],
                                                                  pending_ages={})
                                        for pool in part.pools})
    _, whole = snapshots(two_pool_world())
    full = Planner(frame).plan(whole, [port_pod(p) for p in pods], pending_ages={})
    assert _bytes(partitioning_state_to_dict(sharded)) == _bytes(
        partitioning_state_to_dict(full))


def test_f8_a_pinned_pod_whose_profile_is_free_only_in_another_pool(tables):
    """F8, the reference's as the port's: the unsharded planner's free
    pool is the cluster's, so a pod pinned to pool-a whose 4g.40gb is
    free only in pool-b counts as served: no carve, no reason, on both
    sides. Sharded, pool-a's plan carves for it."""
    nodes = [pool_node("a0", "pool-a"), NodeDesc("b0", free={0: {"4g.40gb": 1}},
                                                 labels={NODEPOOL_LABEL: "pool-b"})]
    pods = [pinned("pa", "4g.40gb", "pool-a")]
    jsnap, tsnap = snapshots(nodes)
    jframe, tframe = frameworks("basic")
    jplanner, jstate = _snap_and_plan(RefPlanner, jframe, jsnap, [ref_pod(p) for p in pods], {})
    tplanner, tstate = _snap_and_plan(Planner, tframe, tsnap, [port_pod(p) for p in pods], {})
    assert port_state(tstate) == ref_state(jstate) == ref_state(jsnap.partitioning_state())
    assert tplanner.last_unserved == expected_unserved(jplanner) == {}
    assert placements(tsnap)["a0"] == []
    _, tsnap = snapshots(nodes)
    tpods = [port_pod(p) for p in pods]
    part = tpools.partition_pools(tsnap, tpods)
    snaps, pending = tpools.split_snapshot(tsnap, part), tpools.split_pending(tpods, part)
    sharded = Planner(tframe).plan(snaps["pool-a"], pending["pool-a"], pending_ages={})
    assert mig("4g.40gb") in sharded["a0"].gpus[0].resources
    assert placements(snaps["pool-a"])["a0"] == ["pa"]


# ------------------------------------------------------------ merge checks

def _parts():
    return (tpools.PoolPartition(pools=("pool-a", "pool-b"),
                                 node_pool={"a0": "pool-a", "b0": "pool-b"}, pod_pool={}),
            jpools.PoolPartition(pools=("pool-a", "pool-b"),
                                 node_pool={"a0": "pool-a", "b0": "pool-b"}, pod_pool={},
                                 merged_from={}, single_pool_reason=""))


def _states(nodes):
    jsnap, tsnap = snapshots(nodes)
    return jsnap.partitioning_state(), tsnap.partitioning_state()


def _pick(state, names):
    return {name: state[name] for name in names}


def _kinds(violations):
    """What a violation is, in words both sides share."""
    keys = ("claimed by pools", "missing from every pool plan", "twice", "exceeds capacity",
            "planned by pool")
    return sorted(next(k for k in keys if k in v) for v in violations)


def _check_both(current, desired, capacities=None):
    tpart, jpart = _parts()
    t = tpools.check_merge_invariants(tpart, current[1], desired[1], capacities)
    j = jpools.check_merge_invariants(jpart, current[0], desired[0], capacities)
    assert _kinds(t) == _kinds(j)
    return t


def test_merge_flags_a_node_claimed_twice(tables):
    jstate, tstate = _states([pool_node("a0", "pool-a"), pool_node("b0", "pool-b")])
    current = ({"pool-a": _pick(jstate, ["a0"]), "pool-b": _pick(jstate, ["b0"])},
               {"pool-a": _pick(tstate, ["a0"]), "pool-b": _pick(tstate, ["b0"])})
    desired = ({"pool-a": _pick(jstate, ["a0", "b0"]), "pool-b": _pick(jstate, ["b0"])},
               {"pool-a": _pick(tstate, ["a0", "b0"]), "pool-b": _pick(tstate, ["b0"])})
    assert any("claimed by pools" in v for v in _check_both(current, desired))


def test_merge_flags_an_unplanned_node(tables):
    jstate, tstate = _states([pool_node("a0", "pool-a"), pool_node("b0", "pool-b")])
    current = ({"pool-a": _pick(jstate, ["a0"]), "pool-b": _pick(jstate, ["b0"])},
               {"pool-a": _pick(tstate, ["a0"]), "pool-b": _pick(tstate, ["b0"])})
    desired = ({"pool-a": _pick(jstate, ["a0"]), "pool-b": {}},
               {"pool-a": _pick(tstate, ["a0"]), "pool-b": {}})
    assert any("missing from every pool plan" in v for v in _check_both(current, desired))


def _one(resource_ref, resource_port, count, index=0, twice=False):
    j = JNodePartitioning(boards=[BoardPartitioning(board_index=index,
                                                    resources={resource_ref: count})]
                          * (2 if twice else 1))
    t = NodePartitioning(gpus=[GpuPartitioning(index, {resource_port: count})]
                         * (2 if twice else 1))
    return j, t


def test_merge_allows_a_recarve_but_not_minting(tables):
    jstate, tstate = _states([pool_node("a0", "pool-a", carved=True), pool_node("b0", "pool-b")])
    current = ({"pool-a": _pick(jstate, ["a0"]), "pool-b": _pick(jstate, ["b0"])},
               {"pool-a": _pick(tstate, ["a0"]), "pool-b": _pick(tstate, ["b0"])})
    caps = {"a0": 8.0, "b0": 8.0}
    j, t = _one("google.com/tpu-slice-2x2", mig("4g.40gb"), 1)
    recarved = ({"pool-a": {"a0": j}, "pool-b": current[0]["pool-b"]},
                {"pool-a": {"a0": t}, "pool-b": current[1]["pool-b"]})
    assert _check_both(current, recarved, caps) == []
    j, t = _one("google.com/tpu-slice-2x4", mig("7g.80gb"), 2)
    minted = ({"pool-a": current[0]["pool-a"], "pool-b": {"b0": j}},
              {"pool-a": current[1]["pool-a"], "pool-b": {"b0": t}})
    assert _check_both(current, minted) == []  # no ceiling given
    assert any("exceeds capacity" in v for v in _check_both(current, minted, {"b0": 8.0}))
    j, t = _one("google.com/tpu-slice-2x2", mig("4g.40gb"), 1, twice=True)
    doubled = ({"pool-a": current[0]["pool-a"], "pool-b": {"b0": j}},
               {"pool-a": current[1]["pool-a"], "pool-b": {"b0": t}})
    assert any("twice" in v for v in _check_both(current, doubled))


def test_merge_is_order_independent(tables):
    _, tsnap = snapshots(two_pool_world())
    part = tpools.partition_pools(tsnap, [port_pod(pinned("pa", "4g.40gb", "pool-a")),
                                          port_pod(pinned("pb", "4g.40gb", "pool-b"))])
    states = {pool: snap.partitioning_state()
              for pool, snap in tpools.split_snapshot(tsnap, part).items()}
    assert tpools.check_merge_invariants(part, states, states) == []
    forward = tpools.merge_pool_states(dict(states))
    backward = tpools.merge_pool_states(dict(reversed(list(states.items()))))
    assert _bytes(partitioning_state_to_dict(forward)) == _bytes(
        partitioning_state_to_dict(backward))
    assert list(forward) == sorted(forward)


def test_capacity_counts_memory_slices_and_mps_gb_over_ten(tables):
    """Port only: a MIG H100 holds 8 memory slices, an MPS one 80 GB (8.0
    at GB / 10); a 3g.40gb counts 4, a gpu-40gb 4.0."""
    _, tsnap = snapshots([NodeDesc("m", gpus=2), NodeDesc("s", gpus=3, mode="mps")])
    nodes = tsnap.get_nodes()
    assert tpools.node_capacity(nodes["m"]) == 16.0
    assert tpools.node_capacity(nodes["s"]) == 24.0
    assert tpools.gpu_size({mig("3g.40gb"): 2, "nvidia.com/gpu-40gb": 1}) == 12.0
    part = tpools.PoolPartition(pools=("default",), node_pool={"m": "default", "s": "default"},
                                pod_pool={})
    over = {"default": {"m": NodePartitioning(
        gpus=[GpuPartitioning(0, {mig("7g.80gb"): 1}), GpuPartitioning(1, {mig("7g.80gb"): 1}),
              GpuPartitioning(2, {mig("1g.10gb"): 1})]),
        "s": NodePartitioning(gpus=[GpuPartitioning(0, {"nvidia.com/gpu-40gb": 2})])}}
    violations = tpools.check_merge_invariants(part, {"default": {}}, over,
                                               tpools.node_capacities([tsnap]))
    assert violations == ["pool default: node m desired 17.0 slices exceeds capacity 16.0"]


# ------------------------------------------------------------ the maintainer

class _BothMaintainers:
    """Four nodes in two pools on both sides, each with its maintainer."""

    def __init__(self):
        from nos_tpu.controllers.partitioner.incremental import (
            PoolShardedMaintainer as JMaintainer,
        )
        from nos_tpu.partitioning.core import ClusterState as JState

        self.jstore, jtaker = _ref_store_and_taker()
        self.tstore = NodeStore()
        for name, pool in (("a0", "pool-a"), ("a1", "pool-a"), ("b0", "pool-b"),
                           ("b1", "pool-b")):
            desc = pool_node(name, pool)
            self.jstore.create(ref_node(desc))
            self.tstore.create(port_node(desc))
        self.jm = JMaintainer(self.jstore, jtaker, kind="tpu")
        self.tm = PoolShardedMaintainer(self.tstore, MigSnapshotTaker(), "mig")
        self.jstate = JState()

    def shard(self, pods):
        tstate = ClusterState()
        for node in self.tstore.list("Node"):
            tstate.update_node(node, [p for p in self.tstore.list("Pod") if p.node == node.name
                                      and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)])
        jout = self.jm.shard(self.jstate, [ref_pod(p) for p in pods])
        tout = self.tm.shard(tstate, [port_pod(p) for p in pods])
        assert self.tm.last_rebuilt == self.jm.last_rebuilt
        assert self.tm.pool_rebuilds == self.jm.pool_rebuilds
        assert tout[1] == jout[1]  # the base's dirty nodes
        assert tout[2].pools == jout[2].pools and tout[2].node_pool == jout[2].node_pool
        assert tout[4] == jout[4]  # each pool's dirty nodes
        return tout


PINNED = [pinned("pa", "4g.40gb", "pool-a"), pinned("pb", "4g.40gb", "pool-b")]


def test_noop_cycles_keep_the_pool_snapshots(tables):
    both = _BothMaintainers()
    _, _, part, snaps, dirty = both.shard(PINNED)
    assert both.tm.last_rebuilt and dirty == {"pool-a": {"a0", "a1"}, "pool-b": {"b0", "b1"}}
    for _ in range(3):
        _, _, part2, snaps2, dirty2 = both.shard(PINNED)
        assert not both.tm.last_rebuilt and dirty2 == {"pool-a": set(), "pool-b": set()}
        assert all(snaps2[pool] is snaps[pool] for pool in part.pools)
    assert both.tm.pool_rebuilds == 1


def test_a_dirty_node_refreshes_only_its_pool(tables):
    both = _BothMaintainers()
    _, _, _, snaps, _ = both.shard(PINNED)
    bound = PodDesc("w0", {mig("1g.10gb"): 1}, node="b1", phase="Running")
    both.jstore.create(ref_pod(bound))
    both.tstore.create(port_pod(bound))
    _, dirty, _, snaps2, dirty2 = both.shard(PINNED)
    assert dirty == {"b1"} and dirty2 == {"pool-a": set(), "pool-b": {"b1"}}
    assert snaps2["pool-b"] is snaps["pool-b"]
    assert [p.name for p in snaps2["pool-b"].get_nodes()["b1"].pods] == ["w0"]


def test_a_partition_change_rebuilds_the_pools(tables):
    both = _BothMaintainers()
    both.shard(PINNED)
    members = [gang(pinned(f"g{i}", "4g.40gb", pool)) for i, pool in
               enumerate(["pool-a", "pool-b"])]
    _, _, part, _, dirty = both.shard(members)
    assert both.tm.last_rebuilt and part.pools == ("pool-a",)
    assert dirty == {"pool-a": {"a0", "a1", "b0", "b1"}} and both.tm.pool_rebuilds == 2


def test_force_rebuild_is_the_escape_hatch(tables):
    both = _BothMaintainers()
    both.shard(PINNED[:1])
    both.tm.force_rebuild()
    both.jm.force_rebuild()
    both.shard(PINNED[:1])
    assert both.tm.last_rebuilt and both.tm.pool_rebuilds == 2


def test_unpinned_plans_shard_into_one_pool_equal_to_the_unsharded_plan(tables):
    pods = [PodDesc("p0", {mig("4g.40gb"): 1}), PodDesc("p1", {mig("1g.10gb"): 1})]
    _, tsnap = snapshots(two_pool_world())
    tpods = [port_pod(p) for p in pods]
    part = tpools.partition_pools(tsnap, tpods)
    assert part.pools == ("pool-a",)
    frame = frameworks("basic")[1]
    snaps, pending = tpools.split_snapshot(tsnap, part), tpools.split_pending(tpods, part)
    sharded = tpools.merge_pool_states(
        {"pool-a": Planner(frame).plan(snaps["pool-a"], pending["pool-a"], pending_ages={})})
    _, whole = snapshots(two_pool_world())
    full = Planner(frame).plan(whole, [port_pod(p) for p in pods], pending_ages={})
    assert _bytes(partitioning_state_to_dict(sharded)) == _bytes(
        partitioning_state_to_dict(full))
