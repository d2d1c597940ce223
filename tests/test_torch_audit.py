"""The invariant auditor (``nos_tpu_torch/record/audit.py``) against
nos_tpu's (``tests/record/test_audit.py`` and the ``InvariantAuditor``
cases of ``tests/partitioning/test_incremental_plan.py:213-250``).

On the translated clusters of tests/torch_planner_cases.py (a v5e board
↔ an H100, 1x1 / 2x2 / 2x4 ↔ 1g.10gb / 4g.40gb / 7g.80gb, one
allowed-geometry table, one monotonic instant), both sides plan the same
pods and audit the result: a clean plan gives no violation on either
side; one poisoned verdict-cache entry keyed at its node's live version
is flagged by exactly ``verdict_cache``, on the same node on both sides;
a poisoned entry at a version the node has left is skipped; the
counter-stride sample is the reference's at every rate; the shadow
replan of an incremental plan agrees with a clean plan, catches a
poisoned desired state and idles on a full plan, as the reference's.
The reference's auditor is driven through its ``check_*`` methods where
it finds violations (its ``publish`` would write the process-wide
registry, which no parity test writes). Port only: each other check
flags its own poisoning, a sharded plan audits clean pool by pool on the
serial and the process backends, the ledger check is the ledger's
``self_check``, and ``publish`` counts, events and records.
"""
import random
import time

import pytest

from nos_tpu.partitioning.core import Planner as JPlanner
from nos_tpu.record import audit as jaudit
from nos_tpu.scheduler import framework as jfw
from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.kube.events import EventRecorder
from nos_tpu_torch.kube.store import Node, NodeStore, Pod
from nos_tpu_torch.partitioning.core import Planner
from nos_tpu_torch.record import FlightRecorder, InvariantAuditor, build_auditor
from nos_tpu_torch.record.audit import CHECKS, AuditViolation
from nos_tpu_torch.scheduler import framework as tfw
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from nos_tpu_torch.timeline.sizes import SIZES
from nos_tpu_torch.util import metrics
from tests.test_torch_incremental import STYLES, style_desc
from tests.test_torch_planner import NOW, snapshots
from tests.torch_planner_cases import NodeDesc, PodDesc, port_pod, ref_pod, same_tables


def mig(profile):
    return f"nvidia.com/mig-{profile}"


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: NOW)
    with same_tables() as geometries:
        yield geometries


def both_frameworks():
    return (jfw.Framework(filter_plugins=[jfw.NodeResourcesFit(), jfw.NodeSelectorFit(),
                                          jfw.NodeAffinityFit(), jfw.TaintTolerationFit()]),
            tfw.Framework(filter_plugins=[tfw.NodeResourcesFit(), tfw.NodeSelectorFit(),
                                          tfw.NodeAffinityFit(), tfw.TaintTolerationFit()]))


def four_nodes():
    """The reference's ``build_snapshot``: seeded, half the boards virgin,
    half with one free 2x2 (a 4g.40gb)."""
    rng = random.Random(42)
    return [NodeDesc(f"n{i}", free={0: {"4g.40gb": 1}} if rng.random() >= 0.5 else {})
            for i in range(4)]


def planned_pair(n_pods=6):
    """Both planners after planning the reference's six 1x1 pods."""
    jsnap, tsnap = snapshots(four_nodes())
    jframe, tframe = both_frameworks()
    jplanner, tplanner = JPlanner(jframe), Planner(tframe)
    pods = [PodDesc(f"p{i}", {mig("1g.10gb"): 1}) for i in range(n_pods)]
    jplanner.plan(jsnap, [ref_pod(p) for p in pods])
    tplanner.plan(tsnap, [port_pod(p) for p in pods])
    return (jplanner, jsnap), (tplanner, tsnap)


class TestCleanPlan:
    def test_no_violations_on_either_side(self, tables):
        (jplanner, jsnap), (tplanner, tsnap) = planned_pair()
        jauditor, tauditor = jaudit.InvariantAuditor(sample_rate=1.0), InvariantAuditor(1.0)
        assert jauditor.audit_plan(jplanner, jsnap, exhaustive=True) == []
        assert tauditor.audit_plan(tplanner, tsnap, exhaustive=True) == []
        assert tauditor.violations_total == jauditor.violations_total == 0
        # the checks had work: a filled verdict cache and a kept tracker total
        assert tplanner._verdict_cache.entries and tplanner.last_tracker is not None

    def test_the_checks_are_the_references(self):
        assert CHECKS == jaudit.CHECKS


def _poison_live_entry(planner, snapshot, probe):
    """Route one probe through the cache so its entry and its pod exist,
    then flip the entry keyed at the node's current version."""
    node_name = sorted(snapshot.get_nodes())[0]
    planner._can_schedule(snapshot, node_name, probe)
    node = snapshot.get_nodes()[node_name]
    for key in list(planner._verdict_cache.entries):
        _, name, version = key
        if name == node_name and version == node.version:
            planner._verdict_cache.entries[key] = not planner._verdict_cache.entries[key]
            return key
    pytest.fail("no live verdict-cache entry to poison")


class TestPoisonedVerdictCache:
    def test_flags_exactly_the_verdict_cache_check_on_both_sides(self, tables):
        (jplanner, jsnap), (tplanner, tsnap) = planned_pair()
        probe = PodDesc("poison-probe", {mig("1g.10gb"): 1})
        jkey = _poison_live_entry(jplanner, jsnap, ref_pod(probe))
        tkey = _poison_live_entry(tplanner, tsnap, port_pod(probe))
        want = jaudit.InvariantAuditor(sample_rate=1.0).check_verdict_cache(
            jplanner, jsnap, exhaustive=True)
        auditor = InvariantAuditor(sample_rate=1.0)
        got = auditor.audit_plan(tplanner, tsnap, exhaustive=True)
        assert got and {v.check for v in got} == {"verdict_cache"}
        assert [v.node for v in got] == [v.node for v in want] == [tkey[1]] == [jkey[1]]
        assert auditor.violations_total == len(got)

    def test_stale_version_entries_are_skipped_on_both_sides(self, tables):
        (jplanner, jsnap), (tplanner, tsnap) = planned_pair()
        probe = PodDesc("stale-probe", {mig("1g.10gb"): 1})
        jpod, tpod = ref_pod(probe), port_pod(probe)
        name = sorted(tsnap.get_nodes())[0]
        jplanner._can_schedule(jsnap, name, jpod)
        tplanner._can_schedule(tsnap, name, tpod)
        jsig = jplanner._sim_pod_cache[(id(jpod), "tpu-v5-lite-podslice")][2]
        tsig = tplanner._simulation_signature(tpod)
        jplanner._verdict_cache.entries[(jsig, name, jsnap.get_nodes()[name].version + 999)] = False
        tplanner._verdict_cache.entries[(tsig, name, tsnap.get_nodes()[name].version + 999)] = False
        assert jaudit.InvariantAuditor(1.0).check_verdict_cache(jplanner, jsnap, True) == []
        assert InvariantAuditor(1.0).check_verdict_cache(tplanner, tsnap, True) == []

    def test_live_mode_caps_the_entries_checked(self, tables):
        (_, _), (tplanner, tsnap) = planned_pair()
        probe = port_pod(PodDesc("cap-probe", {mig("1g.10gb"): 1}))
        for name in sorted(tsnap.get_nodes()):
            tplanner._can_schedule(tsnap, name, probe)
        for key in list(tplanner._verdict_cache.entries):
            tplanner._verdict_cache.entries[key] = not tplanner._verdict_cache.entries[key]
        auditor = InvariantAuditor(sample_rate=1.0, max_entries_per_check=1)
        live = auditor.check_verdict_cache(tplanner, tsnap)
        every = auditor.check_verdict_cache(tplanner, tsnap, exhaustive=True)
        assert len(live) == 1 and len(every) == len(tsnap.get_nodes()) == 4


class TestSampling:
    def test_zero_rate_builds_no_auditor(self):
        assert build_auditor(sample_rate=0.0) is None
        assert jaudit.build_auditor(sample_rate=0.0) is None
        assert isinstance(build_auditor(sample_rate=0.5), InvariantAuditor)

    @pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 1.0])
    def test_the_stride_sequence_is_the_references(self, rate):
        port, ref = InvariantAuditor(sample_rate=rate), jaudit.InvariantAuditor(sample_rate=rate)
        got = [port.should_audit() for _ in range(200)]
        assert got == [ref.should_audit() for _ in range(200)]
        assert sum(got) == round(200 * rate)
        fresh = InvariantAuditor(sample_rate=rate)
        assert got == [fresh.should_audit() for _ in range(200)]  # the same plans again


def _incremental_pair():
    """The reference's ``TestAuditorShadowCheck._incremental_plan`` on both
    sides: six styled nodes, a full-dirty plan, n0 refreshed virgin, an
    incremental plan."""
    from tests.test_torch_incremental import bases, refresh_both

    styles = {f"n{i}": (i % 3) + 1 for i in range(6)}
    jbase, tbase = bases(styles)
    jframe, tframe = both_frameworks()
    jplanner, tplanner = JPlanner(jframe), Planner(tframe)
    descs = [PodDesc(f"p{i}", {mig("1g.10gb"): 1}) for i in range(3)] + [
        PodDesc("big", {mig("7g.80gb"): 1})]
    jpods, tpods = [ref_pod(p) for p in descs], [port_pod(p) for p in descs]
    ages = {p.key: 0.0 for p in descs}
    jplanner.plan(jbase, jpods, pending_ages=dict(ages), dirty=set(styles))
    tplanner.plan(tbase, tpods, pending_ages=dict(ages), dirty=set(styles))
    refresh_both(jbase, tbase, "n0", 0)
    jdesired = jplanner.plan(jbase, jpods, pending_ages=dict(ages), dirty={"n0"})
    tdesired = tplanner.plan(tbase, tpods, pending_ages=dict(ages), dirty={"n0"})
    assert jplanner.last_plan_mode == tplanner.last_plan_mode == "incremental"
    return (jplanner, jbase, jpods, jdesired), (tplanner, tbase, tpods, tdesired)


class TestIncrementalShadowCheck:
    def test_a_clean_incremental_plan_passes(self, tables):
        ref, port = _incremental_pair()
        assert jaudit.InvariantAuditor(1.0).check_incremental_plan(*ref) == []
        assert InvariantAuditor(1.0).check_incremental_plan(*port) == []

    def test_a_poisoned_desired_state_is_caught(self, tables):
        ref, port = _incremental_pair()
        got = []
        for auditor, (planner, base, pods, desired) in (
                (jaudit.InvariantAuditor(1.0), ref), (InvariantAuditor(1.0), port)):
            poisoned = dict(desired)
            poisoned.pop(sorted(poisoned)[0])
            found = auditor.check_incremental_plan(planner, base, pods, poisoned)
            got.append([(v.check, v.subject) for v in found])
        assert got[0] == got[1] == [("incremental_plan", "desired")]

    def test_the_check_idles_outside_incremental_mode(self, tables):
        desc = [style_desc(f"n{i}", 1) for i in range(3)]
        jsnap, tsnap = snapshots(desc)
        jframe, tframe = both_frameworks()
        jplanner, tplanner = JPlanner(jframe), Planner(tframe)
        pod = PodDesc("p0", {mig("1g.10gb"): 1})
        jdesired = jplanner.plan(jsnap, [ref_pod(pod)])
        tdesired = tplanner.plan(tsnap, [port_pod(pod)])
        assert tplanner.last_plan_mode == "full" and len(STYLES) == 5
        assert jaudit.InvariantAuditor(1.0).check_incremental_plan(
            jplanner, jsnap, [ref_pod(pod)], jdesired) == []
        assert InvariantAuditor(1.0).check_incremental_plan(
            tplanner, tsnap, [port_pod(pod)], tdesired) == []


class TestEveryCheckFlagsItsOwnPoison:
    """Port only: each structure poisoned alone trips its own check."""

    def _poison(self, what, planner, snapshot):
        if what == "free_pool":
            snapshot.free_slice_resources()
            snapshot._free_pool[mig("7g.80gb")] = snapshot._free_pool.get(mig("7g.80gb"), 0) + 3
        elif what == "mutation_clock":
            names = sorted(snapshot.get_nodes())
            snapshot.get_nodes()[names[0]].version = snapshot.state_version + 5
        elif what == "lacking_totals":
            tracker = planner.last_tracker
            tracker.lacking_totals()
            tracker._totals[mig("1g.10gb")] = tracker._totals.get(mig("1g.10gb"), 0) + 1
        elif what == "carve_futility":
            name = sorted(snapshot.get_nodes())[0]
            version = snapshot.get_nodes()[name].version
            planner._futility_cache[(name, version, ((mig("1g.10gb"), 1),))] = "poison"

    @pytest.mark.parametrize("what", ["free_pool", "mutation_clock", "lacking_totals",
                                      "carve_futility"])
    def test_the_poisoned_check_fires_alone(self, tables, what):
        jsnap, tsnap = snapshots([NodeDesc(f"n{i}") for i in range(3)])
        planner = Planner(both_frameworks()[1])
        planner.plan(tsnap, [port_pod(PodDesc("big", {mig("7g.80gb"): 4}))])
        auditor = InvariantAuditor(sample_rate=1.0)
        assert auditor.audit_plan(planner, tsnap, exhaustive=True) == []
        self._poison(what, planner, tsnap)
        got = auditor.audit_plan(planner, tsnap, exhaustive=True)
        assert got and {v.check for v in got} == {what}


def test_the_ledger_check_is_the_ledgers_self_check():
    store = NodeStore(clock=lambda: 0.0)
    store.create(Node("n1", labels={"nos.nebuly.com/gpu-partitioning": "mig",
                                    "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"},
                      capacity={"nvidia.com/gpu": 8}, allocatable={"nvidia.com/gpu": 8}))
    store.create(Pod("p", request={mig("1g.10gb"): 1}))
    ledger = CapacityLedger(store, metrics=False)
    ledger.observe(1.0)
    auditor = InvariantAuditor(sample_rate=1.0)
    assert auditor.check_capacity_ledger(ledger) == [] == ledger.self_check()
    assert auditor.check_capacity_ledger(None) == []
    ledger._pending["default/ghost"] = (40, "default")
    diffs = ledger.self_check()
    got = auditor.check_capacity_ledger(ledger)
    assert diffs and [v.detail for v in got] == diffs
    assert {(v.check, v.subject) for v in got} == {("capacity_ledger", "ledger")}


def test_publish_counts_events_and_records():
    store = NodeStore(clock=lambda: 5.0)
    node = store.create(Node("n1"))
    jsnap, tsnap = snapshots([NodeDesc("n1")])
    tsnap.get_nodes()["n1"].node = node
    flight = FlightRecorder()
    auditor = InvariantAuditor(sample_rate=1.0, recorder=EventRecorder(store, clock=store.clock),
                               flight_recorder=flight)
    before = metrics.AUDIT_VIOLATIONS.labels(check="mutation_clock").value
    violation = AuditViolation("mutation_clock", "n1", "ahead", node="n1")
    auditor.publish([violation, AuditViolation("free_pool", "cluster", "off")], tsnap,
                    revision=7)
    SIZES.unregister("record.flight_ring")
    assert metrics.AUDIT_VIOLATIONS.labels(check="mutation_clock").value == before + 1
    events = store.list("Event", namespace="default")
    assert [(e.reason, e.type, e.involved_name, e.message) for e in events] == [
        ("AuditViolation", "Warning", "n1", "mutation_clock: ahead")]
    record = flight.records()[-1]
    assert record["kind"] == "audit" and record["revision"] == 7
    assert [v["check"] for v in record["violations"]] == ["mutation_clock", "free_pool"]
    assert auditor.violations_total == 2


def test_a_sharded_audit_prefixes_each_pools_subjects(tables):
    """Two pools, each an incremental plan (the shadow check armed); the
    second's desired state poisoned: only its pool is named."""
    runs = []
    for pool in ("pool-a", "pool-b"):
        _, (planner, base, pods, desired) = _incremental_pair()
        if pool == "pool-b":
            desired = dict(desired)
            desired.pop(sorted(desired)[0])
        runs.append((pool, planner, base, pods, desired))
    auditor = InvariantAuditor(sample_rate=1.0)
    got = auditor.audit_sharded_plan(runs, snapshot=None, exhaustive=True, revision=3)
    assert [(v.check, v.subject) for v in got] == [("incremental_plan", "pool=pool-b/desired")]
    assert auditor.audit_sharded_plan(runs[:1], exhaustive=True) == []


class _CountingAuditor(InvariantAuditor):
    def __init__(self):
        super().__init__(sample_rate=1.0)
        self.sharded, self.pools = 0, 0

    def audit_sharded_plan(self, pool_runs, **kwargs):
        pool_runs = list(pool_runs)
        self.sharded += 1
        self.pools += len(pool_runs)
        return super().audit_sharded_plan(pool_runs, **kwargs)


@pytest.mark.parametrize("backend", ["serial", "process"])
def test_a_sharded_plan_audits_clean_pool_by_pool(backend):
    """The partitioner's sharded plans audited at a rate of 1, each pool's
    planner (a worker's pool behind its parent-side planner) and the
    ledger: every plan clean. A worker's pool has its cache checks
    counted as skipped (its memos live in the worker); a serial pool
    skips none."""
    # a generous deadline: a loaded host must not escalate every worker's pool
    cluster = SimCluster(pool_sharding=True, pool_backend=backend, capacity_ledger=True,
                         pool_cycle_timeout_seconds=60.0)
    try:
        for i in range(4):
            cluster.add_mig_node(f"n{i}", gpus=2, pool="pool-a" if i < 2 else "pool-b")
        cluster.add_quota("team", {RESOURCE_GPU_MEMORY: 400}, max={RESOURCE_GPU_MEMORY: 400})
        auditor = cluster.mig.auditor = _CountingAuditor()
        for wave in range(2):
            for j, profile in enumerate(["7g.80gb", "4g.40gb", "3g.40gb", "1g.10gb"]):
                cluster.store.create(Pod(f"t{wave}-{j}", "team", request={mig(profile): 1},
                                         node_selector={NODEPOOL_LABEL: ("pool-a",
                                                                         "pool-b")[j % 2]}))
            assert cluster.run_until_idle(300)
        assert auditor.sharded >= 2 and auditor.pools == 2 * auditor.sharded
        assert auditor.violations_total == 0
        assert auditor.audits_run == auditor.sharded
        backends = {b for r in cluster.mig.plans for b in r["backends"].values()}
        assert backend in backends
        if backend == "serial":
            assert auditor.checks_skipped == {}
        else:
            assert auditor.checks_skipped["verdict_cache"] >= 1
            assert auditor.checks_skipped["carve_futility"] == auditor.checks_skipped[
                "verdict_cache"]
        assert all(cluster.check().values()), cluster.check()
    finally:
        cluster.close()
