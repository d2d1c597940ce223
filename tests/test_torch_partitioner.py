"""The actuator, the partitioner controller and the in-process cluster
(nos_tpu_torch.partitioning.core.actuator, nos_tpu_torch.controllers.partitioner,
nos_tpu_torch.cluster).

The actuator and the controller's cold path are held exactly against
nos_tpu's on translated cases (tests/torch_planner_cases.py): the nodes
actuated, in order, with their geometries, the plan's unserved pods and
the number of nodes re-partitioned. The plan-id gate and the batch
windows (driven by an injected clock) are the port's own, polled form of
the reference's event-driven ones. The SimCluster scenarios are
tests/integration/test_e2e.py's that this slice carries, on H100 nodes:
no test binds a pod itself; every pod goes around plan → spec → agent →
status → bind (MIG) or plan → config map → device plugin → bind (MPS).
"""
import ast
import random
import time
from pathlib import Path

import pytest

from nos_tpu.kube.store import KubeStore
from nos_tpu.controllers.partitioner import PartitionerController as JController
from nos_tpu.partitioning.core import Actuator as JActuator
from nos_tpu.partitioning.core import BoardPartitioning, PartitioningPlan as JPlan
from nos_tpu.partitioning.core import NodePartitioning as JNodePartitioning
from nos_tpu.partitioning.core.state import ClusterState as JState
from nos_tpu.partitioning.tpu.snapshot_taker import TpuSnapshotTaker
from nos_tpu.scheduler import framework as jfw
from nos_tpu_torch.cluster import SimCluster, product_label
from nos_tpu_torch.controllers.partitioner import PartitionerController
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.gpu.known import H100_80GB
from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.core import (
    Actuator,
    ClusterState,
    GpuPartitioning,
    NodePartitioning,
    PartitioningPlan,
    Planner,
)
from nos_tpu_torch.controllers.mpsagent import MpsReporter
from nos_tpu_torch.device.sharing import SharedSliceClient, is_mps_resource
from nos_tpu_torch.partitioning import bench_planner
from nos_tpu_torch.partitioning.core import planner as tplanner
from nos_tpu_torch.partitioning.core.codec import is_mig_resource
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.partitioning.mps import MpsPartitioner, MpsSnapshotTaker
from nos_tpu_torch.scheduler import new_framework
from nos_tpu_torch.util.batcher import Batcher
from nos_tpu_torch.util.tracing import TRACER, TraceStore
from tests.test_torch_planner import RefPlanner, expected_unserved
from tests.torch_planner_cases import (
    MIG_PROFILES,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
    running_pods,
    same_tables,
    to_port_resource,
    to_ref_resource,
)

ROOT = Path(__file__).resolve().parents[1]


def mig(profile):
    return f"nvidia.com/mig-{profile}"


def mps(profile):
    return f"nvidia.com/gpu-{profile}"


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    with same_tables() as geometries:
        yield geometries


class Recording:
    def __init__(self):
        self.calls = []

    def apply_partitioning(self, node_name, plan_id, partitioning):
        self.calls.append((node_name, plan_id, partitioning))


def ref_calls(calls):
    """The reference's recorded NodePartitionings as the port's geometries."""
    return [(node, plan, {b.board_index: {TO_MIG_NAME(k): v for k, v in b.resources.items()}
                          for b in np.boards})
            for node, plan, np in calls]


def TO_MIG_NAME(resource):
    return to_port_resource(resource)[len("nvidia.com/mig-"):]


# ------------------------------------------------------------ actuator

def _random_state(rng, names):
    state_t, state_j = {}, {}
    for name in names:
        if rng.random() < 0.2:
            continue
        gpus = []
        for g in range(rng.randint(0, 3)):
            resources = {mig(p): rng.randint(0, 2) for p in rng.sample(MIG_PROFILES, 2)}
            gpus.append((g, {k: v for k, v in resources.items() if v}))
        rng.shuffle(gpus)
        state_t[name] = NodePartitioning([GpuPartitioning(g, dict(r)) for g, r in gpus])
        state_j[name] = JNodePartitioning([BoardPartitioning(g, {to_ref_resource(k): v
                                                                 for k, v in r.items()})
                                           for g, r in gpus])
    return state_t, state_j


@pytest.mark.parametrize("seed", range(15))
def test_actuator_matches_the_reference(seed):
    rng = random.Random(7000 + seed)
    names = [f"n{i}" for i in range(rng.randint(1, 5))]
    current_t, current_j = _random_state(rng, names)
    if rng.random() < 0.3:
        desired_t, desired_j = current_t, current_j
    else:
        desired_t, desired_j = _random_state(rng, names)
    tp, jp = Recording(), Recording()
    applied = Actuator(tp).apply(current_t, PartitioningPlan(desired_t, "7"))
    assert applied == JActuator(jp).apply(current_j, JPlan(desired_j, "7"))
    assert tp.calls == ref_calls(jp.calls)


def test_actuator_links_each_node_for_the_agent():
    tp = Recording()
    desired = {"n1": NodePartitioning([GpuPartitioning(0, {mig("3g.40gb"): 2})])}
    assert Actuator(tp).apply({}, PartitioningPlan(desired, "42")) == 1
    assert tp.calls == [("n1", "42", {0: {"3g.40gb": 2}})]
    linked = TRACER.linked(("reconfig", "n1", "42"))
    assert linked is not None and linked.name == "actuator.apply_node"


# ------------------------------------------------------------ controller

def controllers(nodes, pending):
    jstore, tstore = KubeStore(), NodeStore()
    # the index the reference's build_partitioner registers
    jstore.add_indexer("Pod", "status.phase", lambda p: [p.status.phase])
    for desc in nodes:
        jstore.create(ref_node(desc))
        tstore.create(port_node(desc))
    for p in running_pods(nodes) + list(pending):
        jstore.create(ref_pod(p))
        tstore.create(port_pod(p))
    jrec, trec = Recording(), Recording()
    jctl = JController(jstore, JState(), TpuSnapshotTaker(),
                       RefPlanner(jfw.Framework(filter_plugins=jfw.vanilla_filter_plugins())),
                       JActuator(jrec), kind="tpu", plan_id_fn=lambda: "p1",
                       incremental_planning=False)
    tctl = PartitionerController(tstore, ClusterState(), MigSnapshotTaker(),
                                 Planner(new_framework()), Actuator(trec), "mig",
                                 is_mig_resource, plan_id_fn=lambda: "p1")
    return (jctl, jrec), (tctl, trec)


def _gpu_state(rng, geometries):
    if rng.random() < 0.3:
        return {}, {}
    base = dict(rng.choice(geometries))
    used = {p: k for p, n in base.items() if (k := rng.randint(0, n))}
    free = {p: n - used.get(p, 0) for p, n in base.items() if n - used.get(p, 0) > 0}
    return free, used


@pytest.mark.parametrize("seed", range(15))
def test_process_pending_pods_matches_the_reference(tables, seed):
    rng = random.Random(8000 + seed)
    nodes = []
    for i in range(rng.randint(1, 5)):
        desc = NodeDesc(f"n{i}", gpus=rng.randint(1, 2))
        for gpu in range(desc.gpus):
            free, used = _gpu_state(rng, tables)
            if free:
                desc.free[gpu] = free
            if used:
                desc.used[gpu] = used
        if rng.random() < 0.2:  # an agent still applying its last plan
            desc.annotations = {tannot.SPEC_PARTITIONING_PLAN: "2",
                                tannot.STATUS_PARTITIONING_PLAN: "1"}
        nodes.append(desc)
    pending = [PodDesc(f"p{j:02d}", {mig(rng.choice(MIG_PROFILES)): 1},
                       priority=rng.choice([0, 1]), unschedulable=True)
               for j in range(rng.randint(1, 15))]
    (jctl, jrec), (tctl, trec) = controllers(nodes, pending)
    tctl.sync()  # the port plans from its synced state, as every step does
    assert tctl.process_pending_pods() == jctl.process_pending_pods()
    assert trec.calls == ref_calls(jrec.calls)
    # the reference's reasons and those it leaves out (F1, F3)
    assert tctl.planner.last_unserved == expected_unserved(jctl.planner)
    assert [p.namespaced_name for p in tctl.fetch_pending_pods()] == sorted(
        p.namespaced_name for p in jctl.fetch_pending_pods())
    record = tctl.plans[-1]
    assert record["plan_id"] == "p1" and record["unserved"] == tctl.planner.last_unserved


def _gate_store():
    store = NodeStore()
    store.create(port_node(NodeDesc("n1", gpus=1, annotations={
        tannot.SPEC_PARTITIONING_PLAN: "2", tannot.STATUS_PARTITIONING_PLAN: "1"})))
    store.create(port_pod(PodDesc("p", {mig("3g.40gb"): 1}, unschedulable=True)))
    return store


def test_the_plan_gate_holds_until_every_node_acknowledges():
    store = _gate_store()
    now = [0.0]
    rec = Recording()
    ctl = PartitionerController(store, ClusterState(), MigSnapshotTaker(),
                                Planner(new_framework()), Actuator(rec), "mig",
                                is_mig_resource, batch_timeout_seconds=60,
                                batch_idle_seconds=10, clock=lambda: now[0])
    ctl.step()
    assert ctl.batcher.current_batch_size() == 1 and rec.calls == []
    now[0] = 10.0  # the idle window passes: the batch is released ...
    assert ctl.step() == 0 and rec.calls == [] and not ctl.gate_open()
    # ... and waits for the gate
    assert ctl.batcher.current_batch_size() == 0 and ctl._released
    now[0] = 30.0
    assert ctl.step() == 0 and rec.calls == []
    store.patch_annotations("Node", "n1", "", {tannot.STATUS_PARTITIONING_PLAN: "2"})
    assert ctl.step() == 1  # acknowledged: the held batch is planned
    assert rec.calls[0][0] == "n1" and rec.calls[0][2][0].get("3g.40gb", 0) >= 1
    assert ctl.plans_applied == 1 and ctl.batcher.current_batch_size() == 1  # re-enqueued


def test_the_plan_gate_holds_an_mps_node_until_its_reporter_acknowledges():
    store = NodeStore()
    store.create(port_node(NodeDesc("s1", gpus=2, mode="mps")))
    store.create(port_pod(PodDesc("p", {mps("20gb"): 1}, unschedulable=True)))
    now = [0.0]
    ctl = PartitionerController(store, ClusterState(), MpsSnapshotTaker(),
                                Planner(new_framework()), Actuator(MpsPartitioner(store)),
                                "mps", is_mps_resource, batch_timeout_seconds=60,
                                batch_idle_seconds=10, plan_id_fn=lambda: f"m{now[0]:g}",
                                clock=lambda: now[0])
    ctl.step()
    now[0] = 10.0
    assert ctl.step() == 1  # the first plan: stamped, not yet acknowledged
    node = store.get("Node", "s1")
    assert node.annotations[tannot.SPEC_PARTITIONING_PLAN] == "m10"
    ctl.sync()  # the gate reads the state the step synced
    assert tannot.STATUS_PARTITIONING_PLAN not in node.annotations and not ctl.gate_open()
    now[0] = 20.0  # the re-enqueued pod's window passes: no second plan
    assert ctl.step() == 0 and ctl.plans_processed == 1
    assert list(store.get("ConfigMap", "nos-device-plugin-config").data) == ["s1-m10"]
    MpsReporter(store, SharedSliceClient(store), "s1").reconcile()
    node = store.get("Node", "s1")
    ctl.sync()
    assert node.annotations[tannot.STATUS_PARTITIONING_PLAN] == "m10" and ctl.gate_open()
    ctl.step()  # acknowledged: the held batch is planned
    assert ctl.plans_processed == 2


def test_the_controller_batches_only_pods_it_could_help(tables):
    store = NodeStore()
    store.create(port_node(NodeDesc("n1")))
    for desc in (PodDesc("marked", {mig("1g.10gb"): 1}, unschedulable=True),
                 PodDesc("unmarked", {mig("1g.10gb"): 1}),
                 PodDesc("mps", {mps("20gb"): 1}, unschedulable=True),
                 PodDesc("bound", {mig("1g.10gb"): 1}, node="n1", unschedulable=True)):
        store.create(port_pod(desc))
    ctl = PartitionerController(store, ClusterState(), MigSnapshotTaker(),
                                Planner(new_framework()), Actuator(Recording()), "mig",
                                is_mig_resource, clock=lambda: 0.0)
    ctl.step()
    assert ctl.batcher.current_batch_size() == 1
    ctl.step()  # already in the window: not added twice
    assert ctl.batcher.current_batch_size() == 1


# ------------------------------------------------------------ batcher

def test_batcher_releases_on_the_idle_window():
    now = [0.0]
    b = Batcher(60, 10, clock=lambda: now[0])
    assert (b.timeout, b.idle) == (60, 10) and Batcher().timeout == 60 and Batcher().idle == 10
    assert b.poll() is None and b.deadline() is None
    b.add("a")
    now[0] = 5.0
    b.add("b")  # the idle window restarts at the last add
    now[0] = 14.9
    assert b.poll() is None
    now[0] = 15.0
    assert b.poll() == ["a", "b"] and b.current_batch_size() == 0


def test_batcher_releases_on_the_timeout_window_under_steady_adds():
    now = [0.0]
    b = Batcher(60, 10, clock=lambda: now[0])
    for t in range(0, 60, 5):  # never quiet for 10 s
        now[0] = float(t)
        b.add(t)
        assert b.poll() is None
    now[0] = 60.0
    assert b.poll() == list(range(0, 60, 5))


def test_batcher_without_an_idle_window_waits_for_the_timeout():
    now = [0.0]
    b = Batcher(60, 0, clock=lambda: now[0])
    b.add("x")
    now[0] = 59.0
    assert b.poll() is None and b.deadline() == 60.0  # idle 0: only the timeout
    now[0] = 60.0
    assert b.poll() == ["x"]
    assert b.poll() is None  # nothing more until the next add


# ------------------------------------------------------------ the loop

def running_on(cluster, name, ns="default"):
    pod = cluster.store.try_get("Pod", name, ns)
    return pod is not None and pod.phase == PodPhase.RUNNING and bool(pod.node)


def submit(cluster, name, request, ns="default"):
    cluster.store.create(Pod(name, ns, request=dict(request)))


def test_pending_mig_pod_triggers_carve_and_schedules():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    submit(c, "train", {mig("3g.40gb"): 1}, ns="ml")
    assert c.run_until_idle(100)
    assert running_on(c, "train", "ml")
    assert c.pool.geometry("h100-1")[0].get("3g.40gb", 0) >= 1  # on the (sim) silicon
    node = c.store.get("Node", "h100-1")
    assert (node.annotations[tannot.STATUS_PARTITIONING_PLAN]
            == node.annotations[tannot.SPEC_PARTITIONING_PLAN])
    assert node.allocatable.get(mig("3g.40gb"), 0) >= 1
    assert c.mig.plans_applied >= 1 and c.kubelet.admission_rejects == 0
    assert all(c.check().values()), c.check()


def test_mixed_profiles_pack_one_gpu():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    for name, profile in (("big", "3g.40gb"), ("small-0", "1g.10gb"), ("small-1", "1g.10gb")):
        submit(c, name, {mig(profile): 1}, ns="ml")
    assert c.run_until_idle(100)
    for name in ("big", "small-0", "small-1"):
        assert running_on(c, name, "ml"), name
    assert all(c.check().values())


def test_second_wave_recarves_freed_capacity():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    submit(c, "wave1", {mig("7g.80gb"): 1}, ns="ml")
    assert c.run_until_idle(100) and running_on(c, "wave1", "ml")
    c.store.patch_merge("Pod", "wave1", "ml",
                        lambda p: setattr(p, "phase", PodPhase.SUCCEEDED))
    for i in range(2):
        submit(c, f"wave2-{i}", {mig("3g.40gb"): 1}, ns="ml")
    assert c.run_until_idle(200)
    for i in range(2):
        assert running_on(c, f"wave2-{i}", "ml")
    assert c.pool.geometry("h100-1")[0] == {"3g.40gb": 2}
    assert all(c.check().values())


def test_pending_mps_pod_triggers_config_and_schedules():
    c = SimCluster()
    c.add_mps_node("shared-1", gpus=4)
    submit(c, "infer", {mps("20gb"): 1}, ns="ml")
    assert c.run_until_idle(100) and running_on(c, "infer", "ml")
    node = c.store.get("Node", "shared-1")
    # actuated through the device plugin, not spec geometry annotations;
    # the plan id is stamped and the node's reporter acknowledged it
    spec, _ = tannot.parse_node_annotations(node.annotations)
    assert spec == []
    key = node.labels["nvidia.com/device-plugin.config"]
    assert key in c.store.get("ConfigMap", c.config_map_name).data
    assert key == "shared-1-" + node.annotations[tannot.SPEC_PARTITIONING_PLAN]
    assert node.annotations[tannot.STATUS_PARTITIONING_PLAN] == node.annotations[
        tannot.SPEC_PARTITIONING_PLAN]
    assert node.allocatable.get(mps("20gb"), 0) >= 1
    _, status = tannot.parse_node_annotations(node.annotations)
    assert any(s.status == "used" and s.profile == "20gb" for s in status)
    assert all(c.check().values())


def test_shared_pods_pack_several_gpus():
    c = SimCluster()
    c.add_mps_node("shared-1", gpus=2)
    for i in range(4):  # 4 x 40gb over 2 x 80 GB
        submit(c, f"infer-{i}", {mps("40gb"): 1}, ns="ml")
    assert c.run_until_idle(200)
    for i in range(4):
        assert running_on(c, f"infer-{i}", "ml")
    assert c.store.get("Node", "shared-1").allocatable.get(mps("40gb"), 0) == 4
    assert all(c.check().values())


def test_unservable_pods_stay_pending_with_a_reason():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    c.add_mps_node("shared-1", gpus=1)
    for i in range(3):
        submit(c, f"big-{i}", {mig("7g.80gb"): 1})
    for i in range(3):
        submit(c, f"mem-{i}", {mps("40gb"): 1})
    assert c.run_until_idle(200)
    running = sorted(p.name for p in c.store.list("Pod") if p.phase == PodPhase.RUNNING)
    assert running == ["big-0", "mem-0", "mem-1"]
    unserved = c.unserved()
    assert set(unserved) == {"default/big-1", "default/big-2", "default/mem-2"}
    assert "7g.80gb" in unserved["default/big-1"] and "40gb" in unserved["default/mem-2"]
    assert all(c.check().values())


def test_the_agents_reconfig_span_parents_on_the_actuators_link():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    submit(c, "p", {mig("1g.10gb"): 1})
    assert c.run_until_idle(100) and running_on(c, "p")
    found = False
    for trace in TRACER.store.list():
        spans = {s.span_id: s for s in trace.spans}
        for s in trace.spans:
            if s.name == "migagent.reconfig" and s.attributes.get("node") == "h100-1":
                parent = spans.get(s.parent_id)
                assert parent is not None and parent.name == "actuator.apply_node"
                assert parent.attributes["plan_id"] == s.attributes["plan_id"]
                names = {x.name for x in trace.spans}
                assert {"partitioner.process", "snapshot.take", "partitioner.plan",
                        "partitioner.actuate"} <= names
                found = True
    assert found


def _aging_run(monkeypatch, wall_step, incremental=True):
    """A pod no node can serve, pending for 4 s of the cluster's clock;
    the host's monotonic clock moves ``wall_step`` seconds a read."""
    wall = [0.0]

    def monotonic():
        wall[0] += wall_step
        return wall[0]

    monkeypatch.setattr(tplanner.time, "monotonic", monotonic)
    monkeypatch.setattr(TRACER, "store", TraceStore(4096))
    c = SimCluster(incremental_planning=incremental)
    c.add_mig_node("aging-1", gpus=1)
    submit(c, "half", {mig("4g.40gb"): 1})
    assert c.run_until_idle(100) and running_on(c, "half")
    submit(c, "whole", {mig("7g.80gb"): 1})
    for _ in range(80):
        c.step()
    plans = [(r["pending_ages"], r["desired"], r["unserved"], r["applied"])
             for r in c.mig.plans]
    rescues = sum(s.name == "plan.trial" and bool(s.attributes.get("rescue"))
                  for trace in TRACER.store.list() for s in trace.spans)
    return plans, rescues


def test_pods_age_on_the_clusters_clock_not_the_hosts(monkeypatch):
    still, _ = _aging_run(monkeypatch, 0.0)
    racing, rescues = _aging_run(monkeypatch, 100.0)
    assert racing == still  # a slow host plans as a fast one does
    ages = [plan[0]["default/whole"] for plan in still if "default/whole" in plan[0]]
    assert ages == sorted(set(ages))  # older at every plan
    # virtual seconds, bounded by the 4 s the steps took
    assert tplanner.AGED_RESCUE_SIZE <= max(ages) < 4.0 + 1e-9
    assert all(plan[2].get("default/whole") for plan in still)
    # past the rescue age the aged rescue tried a carve aimed at the pod:
    # seen on the cold path, where each plan starts without the futility
    # memo (incrementally the memo keeps the carve the loop proved futile
    # before, and skips it), which plans the same
    cold, rescues = _aging_run(monkeypatch, 100.0, incremental=False)
    assert cold == still
    assert rescues > 0


class FakeNvml:
    def __init__(self, name, count):
        self._name, self._count = name, count

    def name(self, index):
        return self._name

    def device_count(self):
        return self._count


def test_a_mig_nodes_product_and_count_come_from_nvml():
    assert product_label("NVIDIA H100 80GB HBM3") == H100_80GB
    c = SimCluster()
    node = c.add_mig_node("card", nvml=FakeNvml("NVIDIA H100 80GB HBM3", 3))
    assert node.labels["nvidia.com/gpu.product"] == H100_80GB
    assert node.capacity["nvidia.com/gpu"] == 3
    with pytest.raises(ValueError, match="not in gpu/known.py"):
        c.add_mig_node("t4", nvml=FakeNvml("Tesla T4", 1))
    submit(c, "p", {mig("2g.20gb"): 2})
    assert c.run_until_idle(100) and running_on(c, "p")


def test_run_until_idle_reports_running_out_of_steps():
    c = SimCluster()
    c.add_mig_node("h100-1", gpus=1)
    submit(c, "p", {mig("3g.40gb"): 1})
    assert not c.run_until_idle(1)


# ------------------------------------------------------------ imports

NEW_MODULES = ["nos_tpu_torch/cluster.py", "nos_tpu_torch/util/resources.py",
               "nos_tpu_torch/util/batcher.py",
               "nos_tpu_torch/partitioning/bench_planner.py"] + [
    str(p.relative_to(ROOT)) for d in ("scheduler", "partitioning/core",
                                       "controllers/partitioner")
    for p in sorted((ROOT / "nos_tpu_torch" / d).glob("*.py"))]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_the_control_plane_modules_import_no_torch_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [m for m in names if m.split(".")[0] in ("torch", "jax", "nos_tpu")], names


def test_the_bench_cluster_is_busy_and_the_cache_decides_trials():
    on, off = bench_planner.run([(16, 50)], 8, 1)
    assert on["verdict_cache"] == "on" and off["verdict_cache"] == "off"
    assert on["plan_equals_cache_off"] and on["deterministic"] and off["deterministic"]
    assert on["cache_hits"] > 0 and 0 < on["cache_hit_rate"] < 1
    # demand exceeds the free supply: the carve loop runs to exhaustion
    assert on["pods_unserved"] > 0 and on["pods_placed"] > 0
    assert (on["pods_placed"], on["forks_total"]) == (off["pods_placed"], off["forks_total"])


def test_the_sharded_bench_rows_at_16x50_with_two_pools():
    """``bench_planner --plan-mode sharded``'s rows, serial only: keys,
    incremental replans, and the sharded plan byte-identical to the
    unsharded one where the draw decomposes (every carve of the steady
    cluster is futile, so pool-local carve targets cannot differ)."""
    rows = bench_planner.run_sharded([(16, 50)], 8, 2, pools=2, parallel="serial")
    capacity, sharded, equivalence, warm = rows
    assert capacity["bench"] == "bench_capacity" and capacity["capacity_slices"] == 16 * 8 * 8
    assert 0 < capacity["steady_state_utilization"] < 1
    assert {"p50_replan_ms", "p95_replan_ms", "p50_merge_ms", "cold_plan_ms", "cpus",
            "gc_max_pause_ms"} <= set(sharded)
    assert sharded["pools"] == 2 and sharded["parallelism"] == "serial"
    assert equivalence["pools"] == 2
    assert equivalence["byte_identical"] or not equivalence["draw_decomposes"]
    assert equivalence["draw_decomposes"]
    assert warm["byte_identical"] and warm["nodes_unmatched"] == 0
    assert warm["entries_adopted"] > 0


# ------------------------------------------------------------ gangs

def test_sim_framework_wires_the_reference_filters():
    from nos_tpu.cmd.partitioner import build_sim_framework as jbuild
    from nos_tpu_torch.controllers.partitioner import build_sim_framework

    from tests.torch_planner_cases import PLUGIN_NAMES

    jframe, tframe = jbuild(KubeStore()), build_sim_framework(NodeStore())
    for point in ("pre_filter_plugins", "filter_plugins"):
        assert [p.name for p in getattr(tframe, point)] == [
            PLUGIN_NAMES.get(p.name, p.name) for p in getattr(jframe, point)]


def test_a_waiting_gang_member_is_not_carved_for_twice():
    """Gang member w0 waits in Permit on h0's free 7g.80gb, which the store
    still shows free; w1 finds no whole GPU. The plan keeps w0 on the slice
    it holds and carves h1 for w1 alone, so the gang binds with one
    7g.80gb a node and nothing more is carved."""
    cluster = SimCluster()
    for i in range(2):
        cluster.add_mig_node(f"h{i}", gpus=1, pool="pool-a")
    cluster.store.create(Pod("warm", "ml", request={mig("7g.80gb"): 1}))
    assert cluster.run_until_idle(200)
    warm_node = cluster.store.get("Pod", "warm", "ml").node
    cluster.store.delete("Pod", "warm", "ml")
    labels = {"nos.nebuly.com/gang": "job", "nos.nebuly.com/gang-size": "2"}
    cluster.store.create(Pod("w0", "ml", request={mig("7g.80gb"): 1}, labels=dict(labels)))
    cluster.step()
    assert cluster.scheduler.assumed() == {"ml/w0": warm_node}
    cluster.store.create(Pod("w1", "ml", request={mig("7g.80gb"): 1}, labels=dict(labels)))
    assert cluster.run_until_idle(400)
    pods = {p.name: p for p in cluster.store.list("Pod", namespace="ml")}
    assert all(p.phase == PodPhase.RUNNING for p in pods.values())
    assert pods["w0"].node == warm_node and pods["w1"].node != warm_node
    assert {n: cluster.pool.geometry(n) for n in ("h0", "h1")} == {
        "h0": {0: {"7g.80gb": 1}}, "h1": {0: {"7g.80gb": 1}}}
    assert all(cluster.check().values()), cluster.check()


# ------------------------------------------------------------ F4

def _refusing_node(spec):
    """A one-GPU MIG node whose agent acknowledged plan 7 but reports the
    geometry it had: a used 1g.10gb and three free 2g.20gb."""
    annotations = tannot.status_from_devices({0: {"2g.20gb": 3}}, {0: {"1g.10gb": 1}})
    annotations.update(tannot.spec_from_geometries({0: spec}))
    annotations.update({tannot.SPEC_PARTITIONING_PLAN: "7",
                        tannot.STATUS_PARTITIONING_PLAN: "7"})
    return port_node(NodeDesc("m0", annotations=annotations))


def test_f4_refused_geometries_are_not_planned_again():
    """Fault F4: the planner sees instance counts, not placements, so it
    chose a geometry the agent cannot create (a 4g.40gb must start where
    the used 1g.10gb sits) and re-planned it on every batch. The taker
    keeps each refusal while the GPU reports the same state, and the
    planner skips them all: after two refusals it tries the third
    geometry with a 4g.40gb."""
    from nos_tpu_torch.partitioning.mig import refused_geometries

    pod = Pod("p", "default", request={mig("4g.40gb"): 1}, unschedulable=True)
    held = Pod("held", "default", node="m0", phase=PodPhase.RUNNING,
               request={mig("1g.10gb"): 1})
    taker = MigSnapshotTaker()
    first = {"1g.10gb": 1, "2g.20gb": 1, "4g.40gb": 1}
    second = {"1g.10gb": 2, "1g.20gb": 1, "4g.40gb": 1}
    for spec in (first, second):
        node = _refusing_node(spec)
        assert refused_geometries(node) == {0: spec}
        state = ClusterState()
        state.update_node(node, [held])
        snapshot = taker.take_snapshot(state)
        plan = Planner(new_framework()).plan(snapshot, [pod])
        chosen = {k[len("nvidia.com/mig-"):]: v for g in plan["m0"].gpus
                  for k, v in g.resources.items()}
        assert chosen != spec
    gpu = snapshot.get_nodes()["m0"].partitionable.gpus[0]
    assert gpu.refused == {frozenset(first.items()), frozenset(second.items())}
    assert chosen == {"1g.10gb": 3, "4g.40gb": 1}
    # a plan in flight, or no spec, refuses nothing
    node = _refusing_node(first)
    node.annotations[tannot.STATUS_PARTITIONING_PLAN] = "6"
    assert refused_geometries(node) == {}
