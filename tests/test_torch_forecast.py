"""Placement forecasting (nos_tpu_torch.forecast) against
nos_tpu.forecast.

One description of nodes and pods is built on both stores under the
parity translation (tests/torch_planner_cases.py: a v5e node of one 2x4
board is a MIG node of one H100, 1x1 / 1x2 / 2x2 / 2x4 are 1g.10gb /
2g.20gb / 4g.40gb / 7g.80gb, with the board's tilings as the H100's
allowed geometries on both sides), and both engines forecast it: the
stages, ETAs, re-carve sets, blocking sets, backfill verdicts, heat maps
and the advisor's proposals must be equal, the reference's names
translated (a blocker's "chips" are the port's memory slices). The
reference's planner runs with F1's duplicate taken out and F3 repaired
(``RefPlanner``), as in the planner's parity tests. The cases are
tests/forecast/test_forecast_engine.py's, test_advisor.py's,
test_accuracy.py's and test_forecaster.py's that need no recorder,
replay or profiler; then random pending queues on random clusters.
"""
import json
import random

import pytest

from nos_tpu.capacity import CapacityLedger as JLedger
from nos_tpu.cmd.partitioner import build_sim_framework as j_build_sim_framework
from nos_tpu.cmd.partitioner import register_indexers
from nos_tpu.forecast import DefragAdvisor as JAdvisor
from nos_tpu.forecast import ForecastEngine as JEngine
from nos_tpu.forecast import PlacementForecaster as JForecaster
from nos_tpu.kube.store import KubeStore
from nos_tpu.partitioning.core import ClusterState as JClusterState
from nos_tpu.partitioning.core.planner import Planner as JPlanner
from nos_tpu.partitioning.tpu import TpuSnapshotTaker
from nos_tpu_torch.capacity import CapacityLedger
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.forecast import (
    EXPECTED_COMPLETION_ANNOTATION,
    STAGE_BLOCKED,
    STAGE_FEASIBLE_NOW,
    STAGE_RECARVE,
    CalibrationTracker,
    DefragAdvisor,
    ForecastEngine,
    PlacementForecaster,
    nearest_rank,
)
from nos_tpu_torch.gpu import known as tknown
from nos_tpu_torch.kube.store import NodeStore, Pod
from nos_tpu_torch.partitioning.core import ClusterState, Planner
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from tests.test_torch_planner import RefPlanner
from tests.torch_planner_cases import (
    TO_MIG,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
    running_pods,
    same_tables,
    to_port_resource,
)

T0 = 1_000_000.0


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


class RefForecastPlanner(RefPlanner):
    """``RefPlanner`` for the forecast's trials: F1's refusal and F3's
    repair inside a pass; a claim or backfill trial outside one places
    as the reference's planner does."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.placed_keys = set()
        self.in_pass = False

    def _plan_pass(self, *args, **kwargs):
        self.in_pass = True
        try:
            return super()._plan_pass(*args, **kwargs)
        finally:
            self.in_pass = False

    def _try_add_pod(self, snapshot, node_name, pod):
        if not self.in_pass:
            return JPlanner._try_add_pod(self, snapshot, node_name, pod)
        return super()._try_add_pod(snapshot, node_name, pod)


def gang(name, gang_name="big", size=2, profile="4g.40gb", node="", phase="Pending",
         completion=None):
    ann = {EXPECTED_COMPLETION_ANNOTATION: str(completion)} if completion is not None else {}
    return PodDesc(name, {f"nvidia.com/mig-{profile}": 1}, node=node, phase=phase,
                   labels={GANG_NAME_LABEL: gang_name, GANG_SIZE_LABEL: str(size)},
                   annotations=ann)


def small(name, profile="2g.20gb"):
    return PodDesc(name, {f"nvidia.com/mig-{profile}": 1})


def port_snapshot(store, taker=None):
    state = ClusterState()
    by_node = store.pods_by_node()
    for node in store.list("Node", copy=False):
        state.update_node(node, list(by_node.get(node.name, ())))
    return (taker or MigSnapshotTaker()).take_snapshot(state)


class Both:
    def __init__(self, nodes, pods, generic=True):
        self.jstore = KubeStore()
        register_indexers(self.jstore)
        self.tstore = NodeStore()
        for desc in nodes:
            self.jstore.create(ref_node(desc))
            self.tstore.create(port_node(desc))
        pods = list(pods) + (running_pods(nodes) if generic else [])
        self.pending = [p for p in pods if not p.node]
        for desc in pods:
            self.jstore.create(ref_pod(desc))
            self.tstore.create(port_pod(desc))

    def pending_pods(self):
        names = {(p.ns, p.name) for p in self.pending}
        return ([p for p in self.jstore.list("Pod")
                 if (p.metadata.namespace, p.metadata.name) in names],
                [p for p in self.tstore.list("Pod") if (p.namespace, p.name) in names])

    def engines(self, **kw):
        return (JEngine(RefForecastPlanner(j_build_sim_framework(self.jstore)), **kw),
                ForecastEngine(Planner(build_sim_framework(self.tstore)), **kw))

    def snapshots(self):
        return (TpuSnapshotTaker().take_snapshot(JClusterState(), store=self.jstore),
                port_snapshot(self.tstore))


def translate(value):
    """A reference payload in the port's names."""
    if isinstance(value, dict):
        return {translate_key(k): translate(v) for k, v in value.items()}
    if isinstance(value, list):
        return [translate(v) for v in value]
    return value


def translate_key(key):
    if isinstance(key, str):
        if key in TO_MIG:
            return TO_MIG[key]
        return to_port_resource(key)
    return key


def canonical(payload):
    return json.loads(json.dumps(payload, sort_keys=True))


def forecast_both(both, now=T0, clocks=None, engine_kw=None, advise=False, **kw):
    jengine, tengine = both.engines(**(engine_kw or {}))
    jsnap, tsnap = both.snapshots()
    jpending, tpending = both.pending_pods()
    want = jengine.forecast(jsnap, jpending, now, clocks=clocks, **kw)
    got = tengine.forecast(tsnap, tpending, now, clocks=clocks, **kw)
    if advise:
        want.advisor = JAdvisor(jengine).advise(jsnap, jpending, want.gangs, now, clocks=clocks)
        got.advisor = DefragAdvisor(tengine).advise(tsnap, tpending, got.gangs, now,
                                                    clocks=clocks)
    assert canonical(got.payload()) == canonical(translate(want.payload()))
    assert tsnap._journals == []
    return got


def one(name, free=None, used=None):
    return NodeDesc(name, free={0: free} if free else {}, used={0: used} if used else {})


# ------------------------------------------------------------ the cases

ENGINE_CASES = {
    "feasible_now_on_carved_free_slices": (
        [one("n1", {"4g.40gb": 2})], [gang("g0"), gang("g1")], dict(cycle_seconds=2.0)),
    "recarve_on_uncarved_capacity": (
        [one("n1")], [gang("g0"), gang("g1")], dict(reconfig_seconds=2.5)),
    "blocked_without_hints": (
        [one("n1", used={"4g.40gb": 2})],
        [gang("b0", "old", node="n1", phase="Running"),
         gang("b1", "old", node="n1", phase="Running"), gang("g0"), gang("g1")], {}),
    "blocked_with_hints_prices_the_slowest": (
        [one("n1", used={"4g.40gb": 2})],
        [gang("b0", "old", node="n1", phase="Running", completion=T0 + 30),
         gang("b1", "old", node="n1", phase="Running", completion=T0 + 50),
         gang("g0"), gang("g1")], {}),
    "wait_seconds_from_the_gang_clocks": (
        [one("n1", {"4g.40gb": 2})], [gang("g0"), gang("g1")],
        dict(clocks={"default/big": {"arrival": T0 - 12.0}})),
    "non_gang_pods_are_not_gangs": ([one("n1", {"2g.20gb": 4})], [small("solo")], {}),
    "taking_a_needed_slice_is_unsafe": (
        [one("n1", {"2g.20gb": 2, "4g.40gb": 1})], [gang("g0"), gang("g1"), small("tiny")],
        dict(clocks={"default/big": {"arrival": T0 - 5.0}})),
    "taking_an_unneeded_slice_is_safe": (
        [one("n1", {"4g.40gb": 2}), one("n2", {"2g.20gb": 4})],
        [gang("g0"), gang("g1"), small("tiny")], {}),
    "pair_cap_bounds_the_trials": (
        [one("n1", {"4g.40gb": 2}), one("n2", {"2g.20gb": 4})],
        [gang("g0"), gang("g1")] + [small(f"tiny{i}") for i in range(6)],
        dict(engine_kw=dict(max_backfill_pairs=3))),
    "gang_cap_in_sorted_order": (
        [one("n1", {"4g.40gb": 2})],
        [gang("a0", "alpha", 1), gang("b0", "beta", 1), gang("c0", "gamma", 1)],
        dict(engine_kw=dict(max_gangs=2))),
    "mixed_gangs_and_a_spare": (
        [one("n1", {"2g.20gb": 2, "4g.40gb": 1}), one("n2")],
        [gang("g0"), gang("g1"), gang("h0", "other", 1, "2g.20gb"), small("tiny")],
        dict(clocks={"default/big": {"arrival": T0 - 9.0}})),
}

EXPECTED_STAGES = {
    "feasible_now_on_carved_free_slices": [STAGE_FEASIBLE_NOW],
    "recarve_on_uncarved_capacity": [STAGE_RECARVE],
    "blocked_without_hints": [STAGE_BLOCKED],
    "blocked_with_hints_prices_the_slowest": [STAGE_BLOCKED],
    "taking_a_needed_slice_is_unsafe": [STAGE_RECARVE],
    "taking_an_unneeded_slice_is_safe": [STAGE_FEASIBLE_NOW],
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_reference_cases(case):
    nodes, pods, kw = ENGINE_CASES[case]
    got = forecast_both(Both(nodes, pods, generic=False), **kw)
    if case in EXPECTED_STAGES:
        assert [g.stage for g in got.gangs] == EXPECTED_STAGES[case]
    if case == "recarve_on_uncarved_capacity":
        assert got.gangs[0].recarve == ["n1"] and got.gangs[0].eta_seconds == 3.5
    if case == "blocked_with_hints_prices_the_slowest":
        assert got.gangs[0].eta_seconds == 51.0
    if case == "taking_a_needed_slice_is_unsafe":
        assert [v.safe for v in got.backfill] == [False]
    if case == "pair_cap_bounds_the_trials":
        assert len(got.backfill) == 3


ADVISOR_CASES = {
    "validated_proposal_moves_a_gang_earlier": (
        [one(f"n{i}") for i in range(3)], [gang(f"g{i}", size=4) for i in range(4)]),
    "no_pending_demand_proposes_nothing": ([one("n1")], []),
    "feasible_gang_does_not_validate": (
        [one("n1", {"4g.40gb": 2}), one("n2")], [gang("g0"), gang("g1")]),
    "mostly_used_nodes_do_not_qualify": (
        [one("n1", used={"4g.40gb": 1, "2g.20gb": 1}), one("n2")],
        [gang("b0", "old", node="n1", phase="Running"),
         gang("b1", "old", profile="2g.20gb", node="n1", phase="Running"),
         gang("g0"), gang("g1")]),
}


@pytest.mark.parametrize("case", sorted(ADVISOR_CASES))
def test_advisor_matches_the_reference_cases(case):
    nodes, pods = ADVISOR_CASES[case]
    got = forecast_both(Both(nodes, pods, generic=False), advise=True,
                        clocks={"default/big": {"arrival": T0 - 10.0}})
    if case == "validated_proposal_moves_a_gang_earlier":
        assert got.advisor["validated"] is True
        assert got.advisor["near_empty_nodes"] == ["n0", "n1", "n2"]
    if case == "feasible_gang_does_not_validate":
        assert got.advisor["validated"] is False


# ------------------------------------------------------------ random queues

PROFILES = ("1g.10gb", "2g.20gb", "4g.40gb", "7g.80gb")
GEOMETRIES = [{"4g.40gb": 2}, {"4g.40gb": 1, "2g.20gb": 2}, {"2g.20gb": 4},
              {"4g.40gb": 1, "1g.10gb": 4}, {"2g.20gb": 2, "1g.10gb": 4}, {"7g.80gb": 1}]


def random_case(rng):
    nodes, pods = [], []
    for i in range(rng.randint(2, 5)):
        if rng.random() < 0.25:
            nodes.append(one(f"n{i}"))
            continue
        geometry = rng.choice(GEOMETRIES)
        free, used = {}, {}
        for profile, qty in geometry.items():
            for _ in range(qty):
                target = used if rng.random() < 0.4 else free
                target[profile] = target.get(profile, 0) + 1
        nodes.append(one(f"n{i}", free, used))
    for desc in nodes:
        for profile, qty in sorted((desc.used.get(0) or {}).items()):
            for k in range(qty):
                hint = rng.choice([None, T0 + rng.choice([5, 20, 60])])
                pods.append(gang(f"run-{desc.name}-{profile}-{k}", f"r-{desc.name}-{k}", 1,
                                 profile, node=desc.name, phase="Running", completion=hint))
    clocks = {}
    for g in range(rng.randint(1, 4)):
        size, profile = rng.choice([(1, "4g.40gb"), (2, "4g.40gb"), (2, "2g.20gb"),
                                    (1, "7g.80gb"), (3, "2g.20gb")])
        for k in range(size):
            pods.append(gang(f"g{g}-{k}", f"g{g}", size, profile))
        if rng.random() < 0.7:
            clocks[f"default/g{g}"] = {"arrival": T0 - rng.choice([1.0, 7.0, 30.0])}
    for s in range(rng.randint(0, 4)):
        pods.append(small(f"s{s}", rng.choice(["1g.10gb", "2g.20gb"])))
    return nodes, pods, clocks


@pytest.mark.parametrize("chunk", range(4))
def test_forecasts_match_the_reference_on_random_queues(chunk):
    rng = random.Random(6000 + chunk)
    stages = set()
    for _ in range(8):
        nodes, pods, clocks = random_case(rng)
        got = forecast_both(Both(nodes, pods, generic=False), clocks=clocks, advise=True,
                            cycle_seconds=1.0, reconfig_seconds=rng.choice([0.5, 2.0]))
        stages |= {g.stage for g in got.gangs}
    assert len(stages) >= 2, stages


# ------------------------------------------------------------ accuracy

def test_nearest_rank_and_calibration_match_the_reference():
    from nos_tpu.forecast import CalibrationTracker as JTracker
    from nos_tpu.forecast import nearest_rank as j_nearest_rank

    values = sorted(float(v) for v in range(1, 101))
    for q in (0.5, 0.95, 1.0, 0.01):
        assert nearest_rank(values, q) == j_nearest_rank(values, q)
    assert nearest_rank([7.0], 0.95) == 7.0 and nearest_rank([1.0, 9.0], 0.95) == 9.0
    rng = random.Random(7)
    tracker, jtracker = CalibrationTracker(window=8), JTracker(window=8)
    for _ in range(40):
        args = (rng.choice([None, rng.random() * 10]), rng.random() * 10,
                rng.choice([0.0, rng.random() * 20]), rng.choice(["recarve", "blocked"]))
        assert tracker.add(*args[:3], stage=args[3]) == jtracker.add(*args[:3], stage=args[3])
        assert tracker.payload() == jtracker.payload()
    assert CalibrationTracker().payload()["p95_ratio"] is None


# ------------------------------------------------------------ the forecaster

def forecasters(both, **kw):
    jledger = JLedger(both.jstore, metrics=False)
    tledger = CapacityLedger(both.tstore, metrics=False)
    jf = JForecaster(both.jstore, JClusterState(),
                     RefForecastPlanner(j_build_sim_framework(both.jstore)), TpuSnapshotTaker(),
                     capacity_ledger=jledger, **kw)
    tf = PlacementForecaster(both.tstore, None, Planner(build_sim_framework(both.tstore)),
                             MigSnapshotTaker(), capacity_ledger=tledger, **kw)
    return (jf, jledger), (tf, tledger)


def test_forecaster_publishes_joins_and_flags_staleness_as_the_reference():
    both = Both([one("n1", {"4g.40gb": 2}), one("n2")], [gang("g0"), gang("g1")],
                generic=False)
    (jf, jledger), (tf, tledger) = forecasters(both, default_reconfig_seconds=0.9)
    jpending, tpending = both.pending_pods()
    for ledger in (jledger, tledger):
        ledger.note_gang_arrival("default/big", T0 - 10.0)
    for now in (T0, T0 + 2.0):
        want = jf.run_once(now=now, pending=jpending, cycle_seconds=2.0)
        got = tf.run_once(now=now, pending=tpending, cycle_seconds=2.0)
        assert canonical(got) == canonical(translate(want))
    assert tf._outstanding == jf._outstanding
    assert tf.stale_feasible_now(T0 + 100.0) == jf.stale_feasible_now(T0 + 100.0) \
        == ["default/big"]
    assert tf.debug_payload()["reconfig_seconds"] == 0.9
    for ledger in (jledger, tledger):
        ledger.note_gang_bound("default/big", T0 + 3.0)
    assert tf.calibration.payload() == jf.calibration.payload()
    assert tf.calibration.payload()["p50_ratio"] == 1.0 / 13.0
    assert tf._outstanding == {} and tf.stale_feasible_now(T0 + 100.0) == []
    payload = tf.debug_payload()
    assert payload["runs"] == 2 and payload["forecast"]["gangs"][0]["gang"] == "default/big"


def test_unforecast_bind_is_counted_not_scored():
    store = NodeStore()
    ledger = CapacityLedger(store, metrics=False)
    forecaster = PlacementForecaster(store, None, Planner(build_sim_framework(store)),
                                     MigSnapshotTaker(), capacity_ledger=ledger)
    ledger.note_gang_arrival("ml/ghost", T0)
    forecaster._outstanding["ml/ghost"] = {"now": T0, "eta_seconds": None, "stage": "blocked"}
    ledger.note_gang_bound("ml/ghost", T0 + 4.0)
    payload = forecaster.calibration.payload()
    assert payload["joined"] == 0 and payload["unforecast"] == 1
    assert forecaster.run_once() is None  # no cycle notified, no time given


def test_notify_and_step_run_once_a_cycle_and_never_write():
    both = Both([one("n1", {"4g.40gb": 2})], [gang("g0"), gang("g1")], generic=False)
    _, (tf, _) = forecasters(both)
    _, tpending = both.pending_pods()
    revision = both.tstore.revision
    assert tf.step() is None
    tf.notify_cycle(tpending, now=T0)
    tf.notify_cycle(tpending, now=T0 + 2.0)  # cadence: 0.7 x 1 + 0.3 x 2
    payload = tf.step()
    assert payload["now"] == T0 + 2.0 and tf.step() is None
    assert payload["gangs"][0]["eta_seconds"] == pytest.approx(1.3)
    assert both.tstore.revision == revision


def test_sim_cluster_forecasts_a_gang_through_its_carve_and_joins_its_bind():
    """The wired forecaster (the reference's cmd/partitioner wiring): the
    MIG controller's plan notifies it, it forecasts the waiting gang off
    the controller's shared state before the carve is applied, the
    ledger's gang-bound listener joins the bind, and no run writes."""
    tknown.set_known_geometries(None)  # the H100's own table: the sim pool carves real MIG
    cluster = SimCluster(capacity_ledger=True, forecast=True)
    cluster.add_mig_node("gpu-0", gpus=2)  # the initializer carves 7g.80gb
    for i in range(2):
        cluster.store.create(Pod(f"w{i}", "ml", request={"nvidia.com/mig-4g.40gb": 1},
                                 labels={GANG_NAME_LABEL: "job", GANG_SIZE_LABEL: "2"}))
    forecaster = cluster.forecaster
    step, writes, forecasts = forecaster.step, [], []

    def watched_step():
        revision = cluster.store.revision
        payload = step()
        writes.append(cluster.store.revision - revision)
        if payload is not None:
            forecasts.extend((payload["now"], g["gang"], g["stage"]) for g in payload["gangs"])
        return payload

    forecaster.step = watched_step
    for _ in range(20):
        cluster.step()
    assert all(p.node == "gpu-0" for p in cluster.store.list("Pod"))
    assert forecaster.runs > 0 and sum(writes) == 0
    assert ("ml/job", STAGE_RECARVE) in [(gang, stage) for _, gang, stage in forecasts]
    calibration = forecaster.debug_payload()["calibration"]
    assert calibration["joined"] == 1 and calibration["unforecast"] == 0
    assert forecaster._outstanding == {} and forecaster.stale_feasible_now(cluster.now) == []
    assert [g["gang"] for g in cluster.ledger.recent_gangs] == ["ml/job"]
    assert all(cluster.check().values()), cluster.check()
