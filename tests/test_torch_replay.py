"""Record, then replay (``nos_tpu_torch/record/replay.py``), as
nos_tpu's ``tests/record/test_replay.py`` holds its own.

A threaded suite (``cmd/cluster.py:build_cluster``, every component on
one store, here on an injected clock that ticks a millisecond a read, so
every pod is created within one second and ties on priority) runs under
the flight recorder with the auditor at rate 1: one MIG node and one MPS
node of 8 H100s, two quotas (team-a borrowing), MIG and MPS pods. Its
log replays with zero drift and zero violations, twice, with equal
reports; its ``capacity.observe`` totals replay bit for bit. Perturbed
logs drift: one node's GPUs shrunk in every delta, a flipped scheduler
decision, a capacity total moved by one ulp, a tampered forecast
calibration and a tampered timeline verdict. The forecast records are
``bench_forecast``'s at ``reference()``; the timeline finding a stall
found on an injected clock.
"""
import copy
import itertools
import json
import math
import threading
import time

import pytest

from nos_tpu_torch import bench_forecast as bf
from nos_tpu_torch.api.config import AgentConfig, GpuPartitionerConfig, SchedulerConfig
from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
from nos_tpu_torch.api.v1alpha1.elasticquota import ElasticQuota
from nos_tpu_torch.cmd.cluster import build_cluster
from nos_tpu_torch.cmd.run import seed_node, seed_pod
from nos_tpu_torch.kube.store import NodeStore, PodPhase
from nos_tpu_torch.record import FlightRecorder, ReplaySession, drift_exit_code
from nos_tpu_torch.timeline import detectors as tdet
from nos_tpu_torch.timeline import store as tstore
from nos_tpu_torch.timeline.sizes import SIZES, SizeRegistry
from nos_tpu_torch.timeline.watchdog import WedgeWatchdog

PODS = [{"name": "a-7g", "namespace": "team-a", "mig": "7g.80gb"},
        {"name": "a-3g-0", "namespace": "team-a", "mig": "3g.40gb"},
        {"name": "a-3g-1", "namespace": "team-a", "mig": "3g.40gb"},
        {"name": "a-1g", "namespace": "team-a", "mig": "1g.10gb"},
        {"name": "b-2g", "namespace": "team-b", "mig": "2g.20gb"},
        {"name": "b-4g", "namespace": "team-b", "mig": "4g.40gb"},
        {"name": "s-20", "mps": "20gb"}, {"name": "s-40", "mps": "40gb"}]


class TickingClock:
    """An injected clock: every read moves it a millisecond."""

    def __init__(self, start=1_000_000.0):
        self._ticks = itertools.count()
        self._start = start
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._start + next(self._ticks) * 0.001


def wait_settled(cluster):
    """Every pod past Pending (Running, or Failed where the sim kubelet's
    backstop refused a bind that raced a re-carve: the suite's own
    business, tests/test_torch_cmd_suite.py; the log replays either way),
    then the suite idle."""
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        if all(p.phase != PodPhase.PENDING for p in cluster.pods()):
            break
        time.sleep(0.05)
    assert all(p.phase != PodPhase.PENDING for p in cluster.pods()), [
        (p.name, p.phase, p.node) for p in cluster.pods()]
    assert cluster.wait_idle(timeout=20.0)


def record_suite():
    clock = TickingClock()
    store = NodeStore(clock=clock)
    flight = FlightRecorder(capacity=100_000, clock=clock)
    cluster = build_cluster(
        partitioner_config=GpuPartitionerConfig(batch_window_timeout_seconds=1.0,
                                                batch_window_idle_seconds=0.05,
                                                audit_sample_rate=1.0),
        scheduler_config=SchedulerConfig(retry_seconds=0.2), flight_recorder=flight,
        store=store)
    flight.attach(store)
    try:
        agent = AgentConfig(report_config_interval_seconds=0.2)
        cluster.add_node(seed_node({"name": "mig-0", "partitioning": "mig"}), agent)
        cluster.add_node(seed_node({"name": "mps-0", "partitioning": "mps"}), agent)
        store.create(ElasticQuota("quota", "team-a", {RESOURCE_GPU_MEMORY: 60},
                                  {RESOURCE_GPU_MEMORY: 400}))
        store.create(ElasticQuota("quota", "team-b", {RESOURCE_GPU_MEMORY: 200}))
        for spec in PODS:
            store.create(seed_pod(spec))
        cluster.start()
        wait_settled(cluster)
        # a second wave: a second plan, so the ledger integrates an interval
        for i in range(4):
            store.create(seed_pod({"name": f"b-1g-{i}", "namespace": "team-b",
                                   "mig": "1g.10gb"}))
        wait_settled(cluster)
    finally:
        cluster.stop()
        flight.detach()
        SIZES.unregister("record.flight_ring")
    return json.loads(json.dumps(flight.records())), cluster


@pytest.fixture(scope="module")
def recording():
    records, cluster = record_suite()
    return records, cluster


def kinds(records):
    return {r["kind"] for r in records}


class TestFaithfulReplay:
    def test_zero_drift_zero_violations_twice_with_equal_reports(self, recording):
        records, _ = recording
        assert {"scheduler.cycle", "planner.plan", "actuation", "quota.reconcile",
                "capacity.observe", "delta", "session.start"} <= kinds(records)
        first = ReplaySession(copy.deepcopy(records)).run()
        second = ReplaySession(copy.deepcopy(records)).run()
        assert first.cycles > 0 and first.plans > 0 and first.capacity_observes > 0
        assert first.drifts == [] and first.violations == [], first.render()
        assert first.ok() and drift_exit_code(first) == 0
        assert first == second and first.render() == second.render()
        assert first.seconds > 0 and 0 <= first.audit_seconds <= first.seconds

    def test_the_live_run_audited_clean_and_recorded_its_session(self, recording):
        records, cluster = recording
        assert "audit" not in kinds(records)
        start = records[0]
        assert start["kind"] == "session.start"
        assert {"scheduler_name", "gang_timeout_seconds", "aging_per_second"} <= set(start)
        # the suite's invariants under the recorder's holds (a pod the
        # kubelet's backstop failed is wait_settled's case, not this one's)
        checks = cluster.check()
        checks.pop("pods_running_or_unserved")
        assert all(checks.values()), checks
        assert checks["capacity_ledger_consistent"]

    def test_pods_tied_on_priority_within_one_second_keep_their_order(self, recording):
        records, _ = recording
        created = {r["object"]["name"]: r["object"]["created"] for r in records
                   if r["kind"] == "delta" and r["object"]["kind"] == "Pod"
                   and r["type"] == "ADDED"}
        times = sorted(created[s["name"]] for s in PODS)
        assert times[-1] - times[0] < 1.0 and len(set(times)) == len(times)
        assert any(t != math.floor(t) for t in times)  # not rounded to the second
        report = ReplaySession(copy.deepcopy(records)).run()
        assert not [d for d in report.drifts if d["kind"] == "planner.plan"], report.render()

    def test_capacity_totals_replay_bit_for_bit(self, recording):
        records, _ = recording
        observes = [r for r in records if r["kind"] == "capacity.observe"]
        assert len(observes) >= 2 and observes[-1]["totals"]["total"] > 0
        perturbed = copy.deepcopy(records)
        last = [r for r in perturbed if r["kind"] == "capacity.observe"][-1]
        last["totals"]["total"] = math.nextafter(last["totals"]["total"], math.inf)
        report = ReplaySession(perturbed).run()
        assert [d["seq"] for d in report.drifts] == [last["seq"]], report.render()

    def test_the_components_events_are_in_the_store(self, recording):
        _, cluster = recording
        reasons = {e.reason for e in cluster.store.list("Event", copy=False)}
        assert {"Scheduled", "FailedScheduling", "QuotaBorrowed"} <= reasons, reasons


class TestPerturbedReplay:
    def test_a_shrunken_node_gives_drift(self, recording):
        records = copy.deepcopy(recording[0])
        shrunk = 0
        for r in records:
            obj = r.get("object") or {}
            if r["kind"] == "delta" and obj.get("kind") == "Node" and obj["name"] == "mig-0":
                for field in ("capacity", "allocatable"):
                    obj[field] = {"cpu": 8, "memory": 128}
                obj["annotations"] = {}
                shrunk += 1
        assert shrunk
        report = ReplaySession(records).run()
        assert report.drifts and not report.ok(), report.render()
        assert drift_exit_code(report) == 1

    def test_a_flipped_recorded_decision_is_drift(self, recording):
        records = copy.deepcopy(recording[0])
        cycle = next(r for r in records if r["kind"] == "scheduler.cycle")
        cycle["decision"] = "fail" if cycle["decision"] != "fail" else "bind"
        cycle["node"] = ""
        cycle["bound"] = []
        report = ReplaySession(records).run()
        assert any(d["kind"] == "scheduler.cycle" and d["seq"] == cycle["seq"]
                   for d in report.drifts), report.render()


class TestForecastReplay:
    def test_forecast_outcomes_replay_and_a_tampered_one_drifts(self):
        records = []
        report = bf.run_bench(records=records)
        assert report["replay"] == {"records": len(records), "forecast_cycles": 94,
                                    "forecast_outcomes": 40, "drifts": 0, "ok": True}
        replayed = ReplaySession(copy.deepcopy(records)).run()
        assert (replayed.forecast_cycles, replayed.forecast_outcomes) == (94, 40)
        assert replayed.ok()
        tampered = copy.deepcopy(records)
        outcome = [r for r in tampered if r["kind"] == "forecast.outcome"][3]
        outcome["calibration"]["joined"] += 1
        drifts = ReplaySession(tampered).run().drifts
        assert [d["seq"] for d in drifts] == [outcome["seq"]]


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class TestTimelineReplay:
    def test_a_stall_finding_replays_and_a_tampered_verdict_drifts(self):
        clock, values = _Clock(), {"beats": 0.0}
        flight = FlightRecorder(clock=clock)
        SIZES.unregister("record.flight_ring")
        timeline = tstore.TimelineStore(
            clock=clock, vitals=False, metrics_fn=lambda: dict(values), sizes=SizeRegistry(),
            watchdog=WedgeWatchdog(),
            policy=tstore.DetectorPolicy(stall_flat_windows=2, stall_series=("beats",)))
        timeline.attach(flight=flight)
        for step in range(5):
            clock.now += 1.0
            values["beats"] = float(min(step, 1) + 1)
            timeline.tick()
        records = json.loads(json.dumps(flight.records()))
        findings = [r for r in records if r["kind"] == "timeline.finding"]
        assert [(f["detector"], f["series"]) for f in findings] == [(tdet.STALL, "beats")]
        assert findings[0]["window"] and findings[0]["params"]
        report = ReplaySession(copy.deepcopy(records)).run()
        assert report.timeline_findings == 1 and report.ok(), report.render()
        findings[0]["verdict"]["flat_since"] = -1.0
        assert [d["kind"] for d in ReplaySession(records).run().drifts] == ["timeline.finding"]
