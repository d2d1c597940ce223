"""Pool planning in worker processes (``partitioning/core/procpool.py``),
its wire (``kube/flatwire.py``, ``snapcodec.py``'s frames) and the
controller's process backend, port against port.

- The frames (tests/partitioning/test_procpool.py:88-123): a round trip,
  bad magic, another codec version, a truncated payload, a short header,
  a payload that is not an object, and a transport that never pickles.
- The wire projection: ``from_wire(to_wire(x)) == x`` on every field of
  the nodes, pods and quotas the parity cases build (gang members, quota
  pods, affinity, spread, tolerations, owners) and of a ``SimCluster``'s
  store after a multi-node gang formed, through JSON.
- ``framework_spec``: the planner's simulation framework ships; a
  framework with a Permit or the scheduler's gang state does not, and a
  controller given one plans its pools serially (``PLAN_BACKEND``).
- One worker bootstrapped on F4's input (the node of
  ``test_f4_refused_geometries_are_not_planned_again``, its two refusals
  on the wire) plans what the parent's serial planner plans and never the
  refused geometries; a bootstrap of another codec version is refused; a
  truncated frame ends the worker, and the parent respawns it; its warm
  export adopts.
- On a 2-pool, 4-node MIG world with a quota (min = max) whose pods lie
  in both pools, ``SimCluster(pool_sharding=True, pool_backend="process")``
  ends with the placements, geometries and unserved reasons of
  ``pool_backend="serial"``, plan for plan; the worker of one pool is
  killed after the first plan: that pool's next plan is planned in the
  parent (the same plan) and the plan after runs on a respawned worker.

Two ``PoolWorkerPool``s in the whole file, each of at most two workers
(module fixtures): a worker's process starts from a fork server that
imports the package (``torch`` included) once, in a few seconds.
"""
import json
import os
import re
import signal
import struct
from pathlib import Path

import pytest

from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.partitioner import build_sim_framework
from nos_tpu_torch.gpu.node import RESOURCE_GPU
from nos_tpu_torch.kube import flatwire
from nos_tpu_torch.kube.store import (
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeStore,
    OwnerReference,
    Pod,
    PodAffinityTerm,
    PodPhase,
    TopologySpreadConstraint,
)
from nos_tpu_torch.partitioning.core import ClusterState, Planner
from nos_tpu_torch.partitioning.core import procpool
from nos_tpu_torch.partitioning.core.procpool import (
    PendingSeenLedger,
    PoolWorkerPool,
    WorkerUnavailable,
    framework_spec,
    planner_knobs,
    snapshot_node_to_wire,
)
from nos_tpu_torch.partitioning.core.snapcodec import (
    SNAPSHOT_CODEC_VERSION,
    FrameError,
    WarmStateCodec,
    decode_frame,
    encode_frame,
)
from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
from nos_tpu_torch.scheduler import new_framework
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL
from tests.test_torch_partitioner import _refusing_node
from tests.torch_planner_cases import NodeDesc, PodDesc, port_node, port_pod
from tests.torch_quota_cases import QuotaDesc, port_quota

# liveness bounds for a loaded host, not timings
BOOT_TIMEOUT = 120.0
CYCLE_TIMEOUT = 60.0


def mig(profile):
    return f"nvidia.com/mig-{profile}"


# ------------------------------------------------------------ frames

def test_a_frame_round_trips():
    doc = {"op": "cycle", "deltas": [], "ages": {"default/p": 1.5}}
    assert decode_frame(encode_frame(doc)) == doc


def test_bad_magic_is_refused_before_the_payload():
    data = bytearray(encode_frame({"op": "ping"}))
    data[:4] = b"XXXX"
    with pytest.raises(FrameError, match="magic"):
        decode_frame(bytes(data))


def test_another_codec_version_is_refused():
    data = bytearray(encode_frame({"op": "ping"}))
    data[4:8] = (SNAPSHOT_CODEC_VERSION + 1).to_bytes(4, "big")
    with pytest.raises(FrameError, match="codec version"):
        decode_frame(bytes(data))


def test_a_truncated_payload_is_refused():
    with pytest.raises(FrameError, match="truncated"):
        decode_frame(encode_frame({"op": "ping"})[:-3])


def test_a_short_header_is_refused():
    with pytest.raises(FrameError, match="short"):
        decode_frame(b"NOSW")


def test_a_payload_that_is_not_an_object_is_refused():
    payload = b"[1,2]"
    header = struct.pack(">4sII", b"NOSW", SNAPSHOT_CODEC_VERSION, len(payload))
    with pytest.raises(FrameError, match="not object"):
        decode_frame(header + payload)


def test_the_transport_never_pickles():
    text = Path(procpool.__file__).read_text()
    assert "import pickle" not in text
    assert re.search(r"\bconn\.send\(", text) is None and "send_bytes" in text


# ------------------------------------------------------------ the wire projection

def _wire_round_trip(obj, to_wire, from_wire):
    doc = json.loads(json.dumps(to_wire(obj)))
    assert from_wire(doc) == obj
    return doc


def test_nodes_pods_and_quotas_round_trip_on_every_field():
    term = PodAffinityTerm(topology_key="kubernetes.io/hostname", match_labels={"app": "x"},
                           match_expressions=[NodeSelectorRequirement("tier", "In", ["a"])],
                           namespaces=["ml"])
    pods = [
        PodDesc("plain", {mig("1g.10gb"): 1}),
        PodDesc("gang", {mig("4g.40gb"): 1}, ns="ml", priority=5, created=12.5,
                labels={GANG_NAME_LABEL: "g", GANG_SIZE_LABEL: "2"},
                selector={NODEPOOL_LABEL: "pool-a"},
                tolerations=[("dedicated", "Equal", "x", "NoSchedule")],
                node_affinity=[NodeSelectorTerm([NodeSelectorRequirement("pool", "NotIn",
                                                                         ["b"])])],
                pod_affinity=[term], pod_anti_affinity=[term],
                spread=[TopologySpreadConstraint("zone", 2, "ScheduleAnyway", {"app": "x"})],
                annotations={"k": "v"}),
        PodDesc("quota", {mig("7g.80gb"): 1, RESOURCE_GPU_MEMORY: 80}, ns="team-a",
                node="n0", phase="Running", unschedulable=True),
    ]
    for desc in pods:
        pod = port_pod(desc)
        pod.uid, pod.nominated_node, pod.hostname = "uid-7", "n1", "h"
        pod.owner = OwnerReference("Pod", "leader", "uid-1")
        pod.env = {"RANK": "1"}
        _wire_round_trip(pod, flatwire.pod_to_wire, flatwire.pod_from_wire)
    node = port_node(NodeDesc("n0", gpus=2, free={0: {"1g.10gb": 2}}, used={1: {"7g.80gb": 1}},
                              taints=[("dedicated", "x", "NoSchedule")], unschedulable=True,
                              labels={NODEPOOL_LABEL: "pool-a"}))
    _wire_round_trip(node, flatwire.node_to_wire, flatwire.node_from_wire)
    eq = port_quota(QuotaDesc("team-a", min={RESOURCE_GPU_MEMORY: 80},
                              max={RESOURCE_GPU_MEMORY: 160}))
    eq.used = {RESOURCE_GPU_MEMORY: 40}
    ceq = port_quota(QuotaDesc("admin", min={RESOURCE_GPU_MEMORY: 80}, name="c",
                               namespaces=["t1", "t2"]))
    _wire_round_trip(eq, flatwire.eq_to_wire, flatwire.eq_from_wire)
    _wire_round_trip(ceq, flatwire.ceq_to_wire, flatwire.ceq_from_wire)
    assert procpool.quotas_from_wire(json.loads(json.dumps(
        procpool.quotas_to_wire([eq], [ceq])))) == [eq, ceq]


def test_a_sim_clusters_objects_round_trip():
    """A multi-node gang's members (owner, hostname, subdomain, env,
    labels and annotations the expander wrote) and its nodes."""
    cluster = SimCluster()
    for i in range(2):
        cluster.add_mig_node(f"n{i}", gpus=8, pool="pool-a")
    cluster.store.create(Pod("job", "default", request={RESOURCE_GPU: 16}))
    cluster.run_until_idle(100)
    for pod in cluster.store.list("Pod"):
        _wire_round_trip(pod, flatwire.pod_to_wire, flatwire.pod_from_wire)
    for node in cluster.store.list("Node"):
        _wire_round_trip(node, flatwire.node_to_wire, flatwire.node_from_wire)
    assert any(p.owner is not None for p in cluster.store.list("Pod"))


def test_a_wire_doc_leaves_out_fields_at_their_defaults():
    pod = Pod("p", "ml", request={mig("1g.10gb"): 1}, priority=0, unschedulable=True)
    doc = _wire_round_trip(pod, flatwire.pod_to_wire, flatwire.pod_from_wire)
    assert doc == {"name": "p", "namespace": "ml", "request": {mig("1g.10gb"): 1},
                   "unschedulable": True}


# ------------------------------------------------------------ spec, knobs, ages

def test_the_simulation_framework_ships_and_the_schedulers_does_not():
    store = NodeStore()
    spec = framework_spec(build_sim_framework(store))
    assert spec == {"pre_filter": ["CapacityScheduling"],
                    "filter": ["NodeUnschedulableFit", "TaintTolerationFit", "NodeAffinityFit",
                               "NodeSelectorFit", "PodTopologySpreadFit",
                               "InterPodAffinityFit", "NodeResourcesFit", "MultinodeFilter",
                               "BoardReservation"],
                    "gpu_memory_gb": None, "reservation": [30.0, 10.0]}
    rebuilt = procpool.build_framework_from_spec(json.loads(json.dumps(spec)), NodeStore())
    assert [type(p).__name__ for p in rebuilt.filter_plugins] == spec["filter"]
    assert framework_spec(new_framework(store)) is None  # Permit, PostFilter, Reserve
    assert planner_knobs(Planner(new_framework())) == {
        "verdict_cache_enabled": True, "futility_memo_enabled": True,
        "incremental_dirty_threshold": 0.25}


def test_the_ledger_ages_pods_on_the_parents_clock():
    now = [100.0]
    ledger = PendingSeenLedger(lambda: now[0])
    a = Pod("a", uid="u1")
    assert ledger.ages([a]) == {"default/a": 0.0}
    now[0] = 103.0
    assert ledger.ages([a, Pod("b", uid="u2")]) == {"default/a": 3.0, "default/b": 0.0}
    # recreated under its name: a new uid starts at 0
    now[0] = 104.0
    assert ledger.ages([Pod("a", uid="u3")]) == {"default/a": 0.0}
    # a sighting unseen past the TTL is forgotten, as in the planner
    now[0] = 104.0 + 601.0
    assert ledger.ages([Pod("b", uid="u2")]) == {"default/b": 602.0}
    assert set(ledger._seen) == {("default/b", "u2")}


# ------------------------------------------------------------ one worker

@pytest.fixture(scope="module")
def f4_worker():
    """One MIG worker (pool "p") and the parent's F4 snapshot: the node
    whose agent refused two geometries, both kept by the parent's
    taker."""
    held = Pod("held", "default", node="m0", phase=PodPhase.RUNNING,
               request={mig("1g.10gb"): 1}, uid="uid-held")
    taker = MigSnapshotTaker()
    for spec in ({"1g.10gb": 1, "2g.20gb": 1, "4g.40gb": 1},
                 {"1g.10gb": 2, "1g.20gb": 1, "4g.40gb": 1}):
        state = ClusterState()
        state.update_node(_refusing_node(spec), [held])
        snapshot = taker.take_snapshot(state)
    store = NodeStore()
    spec = framework_spec(build_sim_framework(store))
    workers = PoolWorkerPool("mig", "MigSliceCodec", spec, planner_knobs(Planner(new_framework())),
                             cycle_timeout_seconds=CYCLE_TIMEOUT,
                             bootstrap_timeout_seconds=BOOT_TIMEOUT)
    workers.sync_pools(["p"])
    entries = [snapshot_node_to_wire(snapshot.get_nodes()["m0"])]
    workers.bootstrap("p", entries, [])
    yield workers, snapshot, entries
    workers.close()


POD = Pod("p", "default", request={mig("4g.40gb"): 1}, unschedulable=True, uid="uid-p")
REFUSED = ({"1g.10gb": 1, "2g.20gb": 1, "4g.40gb": 1}, {"1g.10gb": 2, "1g.20gb": 1, "4g.40gb": 1})


def _cycle(workers, pods=(POD,)):
    return workers.plan_cycle({"p": {
        "deltas": [], "pending": [p.namespaced_name for p in pods],
        "pending_docs": {p.namespaced_name: flatwire.pod_to_wire(p) for p in pods},
        "ages": [0.0 for _ in pods], "external_usage": {}, "context": [], "now": 0.0}})["p"]


def test_a_worker_plans_f4s_node_as_the_parent_does(f4_worker):
    workers, snapshot, entries = f4_worker
    assert entries[0]["refused"] == {"0": sorted(sorted([list(i) for i in g.items()])
                                                 for g in REFUSED)}
    reply = _cycle(workers)
    assert isinstance(reply, dict), reply
    gpu0 = {k[len("nvidia.com/mig-"):]: v for k, v in reply["touched"]["m0"]["0"].items()}
    parent = Planner(build_sim_framework(NodeStore())).plan(
        snapshot, [POD], pending_ages={}, dirty=set(snapshot.get_nodes()))
    assert gpu0 == {k[len("nvidia.com/mig-"):]: v for k, v in parent["m0"].gpus[0].resources.items()}
    assert gpu0 == {"1g.10gb": 3, "4g.40gb": 1} and gpu0 not in REFUSED
    assert workers.ready[0][1] is True  # torch came with the fork server's modules


def test_a_worker_refuses_another_codec_version(f4_worker):
    workers, _, _ = f4_worker
    worker = workers._workers["p"]
    worker.send({"op": "bootstrap", "seq": 99, "codec_version": SNAPSHOT_CODEC_VERSION + 1})
    reply = worker.recv(CYCLE_TIMEOUT)
    assert reply["op"] == "reject" and "codec version" in reply["detail"]


def test_a_worker_exports_warm_state_that_adopts(f4_worker, tmp_path):
    workers, snapshot, _ = f4_worker
    entries, signatures = workers.export_warm("p")
    codec = WarmStateCodec(str(tmp_path / "warm.json"))
    assert codec.save_entries(snapshot, entries, signatures=signatures, force=True)
    report = WarmStateCodec(str(tmp_path / "warm.json")).adopt(snapshot, Planner(new_framework()))
    assert report.matched == 1 and report.adopted_entries == sum(
        len(e["futility"]) + len(e["verdicts"]) for e in entries.values())


def test_a_cycle_sends_only_the_pending_pods_the_worker_lacks(f4_worker):
    """``plan_pools`` sends a pending pod's doc once, and again only when
    the pod changed; the worker plans what the parent plans each time."""
    workers, snapshot, _ = f4_worker
    worker = workers._workers["p"]
    sent_docs = []
    send = worker.send
    worker.send = lambda doc: (sent_docs.append(sorted(doc.get("pending_docs", ()))), send(doc))
    other = Pod("q", "default", request={mig("1g.10gb"): 1}, unschedulable=True, uid="uid-q")
    framework = build_sim_framework(NodeStore())

    def plan(pods):
        plans = workers.plan_pools({"p": snapshot}, {"p": set()}, {"p": list(pods)},
                                   {"p": Planner(framework)}, rebuilt=False, now=0.0)
        parent = Planner(framework)
        desired = parent.plan(snapshot, list(pods), pending_ages={},
                              dirty=set(snapshot.get_nodes()))
        assert plans["p"].backend == "process"
        assert plans["p"].desired == desired and plans["p"].unserved == parent.last_unserved
        return workers.last_frame_bytes

    try:
        first = plan([POD, other])
        again = plan([POD, other])
        plan([POD, Pod("q", "default", request={mig("2g.20gb"): 1}, unschedulable=True,
                       uid="uid-q")])
    finally:
        worker.send = send
    assert sent_docs == [["default/p", "default/q"], [], ["default/q"]]
    assert again < first


def test_a_truncated_frame_ends_the_worker_and_the_parent_respawns_it(f4_worker):
    workers, _, entries = f4_worker
    worker = workers._workers["p"]
    worker.conn.send_bytes(encode_frame({"op": "ping"})[:-2])
    assert worker.recv(CYCLE_TIMEOUT)["op"] == "error"
    unavailable = _cycle(workers)
    assert isinstance(unavailable, WorkerUnavailable) and "p" not in workers.pools()
    workers.bootstrap("p", entries, [])  # a fresh worker from a fresh image
    assert isinstance(_cycle(workers), dict)
    assert workers.restarts == 1 and workers.spawned == 2


# ------------------------------------------------------------ the controller, port against port

def _world(backend):
    cluster = SimCluster(pool_sharding=True, pool_backend=backend,
                         pool_cycle_timeout_seconds=CYCLE_TIMEOUT)
    for i in range(4):
        cluster.add_mig_node(f"n{i}", gpus=2, pool="pool-a" if i < 2 else "pool-b")
    # the team's quota holds 5 whole GPUs (min = max: it couples no pools);
    # its pods lie in both pools, so each worker needs the other's usage
    cluster.add_quota("team", {RESOURCE_GPU_MEMORY: 400}, max={RESOURCE_GPU_MEMORY: 400})
    for j, profile in enumerate(["7g.80gb", "4g.40gb", "3g.40gb", "7g.80gb", "1g.10gb",
                                 "2g.20gb", "7g.80gb", "4g.40gb", "1g.10gb", "7g.80gb"]):
        cluster.store.create(Pod(f"t{j}", "team", request={mig(profile): 1},
                                 node_selector={NODEPOOL_LABEL: ("pool-a", "pool-b")[j % 2]}))
    for j, profile in enumerate(["1g.10gb", "2g.20gb", "1g.10gb", "4g.40gb"]):
        cluster.store.create(Pod(f"o{j}", "other", request={mig(profile): 1},
                                 node_selector={NODEPOOL_LABEL: ("pool-a", "pool-b")[j % 2]}))
    return cluster


def _outcome(cluster):
    pods = {p.namespaced_name: (p.node, p.phase) for p in cluster.store.list("Pod")}
    geometry = {n.name: sorted((k, v) for k, v in n.annotations.items() if "spec-gpu" in k)
                for n in cluster.store.list("Node")}
    plans = [(r["desired"], r["unserved"]) for r in cluster.mig.plans]
    return pods, geometry, cluster.unserved(), plans


@pytest.fixture(scope="module")
def runs():
    serial = _world("serial")
    assert serial.run_until_idle(300)
    process = _world("process")
    killed = []

    def kill_after_the_first_plan():
        if process.mig.plans_processed == 1 and not killed:
            pid = process.mig._worker_pool.pids()["pool-a"]
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)

    try:
        idle = process.run_until_idle(300, on_step=kill_after_the_first_plan)
        yield serial, process, idle, killed
    finally:
        process.close()


def test_the_process_backend_plans_what_the_serial_backend_plans(runs):
    serial, process, idle, _ = runs
    assert idle
    want, got = _outcome(serial), _outcome(process)
    assert got[0] == want[0]  # placements
    assert got[1] == want[1]  # geometries
    assert got[2] == want[2]  # unserved reasons
    assert got[3] == want[3]  # every plan's desired state and unserved pods
    assert any("max exceeded" in reason for reason in got[2].values())
    for cluster in (serial, process):
        assert all(cluster.check().values()), cluster.check()


def test_a_killed_worker_escalates_then_respawns(runs):
    _, process, _, killed = runs
    assert killed
    backends = [r["backends"] for r in process.mig.plans]
    assert backends[0] == {"pool-a": "process", "pool-b": "process"}
    assert backends[1]["pool-a"] == "escalated" and backends[1]["pool-b"] == "process"
    assert all(b == {"pool-a": "process", "pool-b": "process"} for b in backends[2:])
    assert len(backends) > 2
    workers = process.mig._worker_pool
    assert workers.restarts >= 1 and killed[0] not in workers.pids().values()
    assert all(seconds > 0 for seconds, _ in workers.ready)


def test_the_controller_plans_pools_serially_or_on_workers_only():
    """``pool_backend`` is ``""``, ``serial`` or ``process``: threads plan
    no faster than one pool after another, so the controller has none."""
    with pytest.raises(ValueError, match="pool_backend"):
        SimCluster(pool_sharding=True, pool_backend="thread")


def test_a_framework_no_worker_can_build_plans_serially():
    """``framework_spec`` refuses a framework with a Permit point (the
    scheduler's): the process backend is switched off with a warning and
    the pools are planned serially, counted on PLAN_BACKEND."""
    from nos_tpu_torch.controllers.partitioner import PartitionerController
    from nos_tpu_torch.gpu.node import PARTITIONING_MIG
    from nos_tpu_torch.partitioning.core import Actuator
    from nos_tpu_torch.partitioning.core.codec import is_mig_resource
    from nos_tpu_torch.partitioning.mig import MigPartitioner
    from nos_tpu_torch.util import metrics

    store = NodeStore()
    for i, pool in enumerate(("pool-a", "pool-b")):
        store.create(port_node(NodeDesc(f"n{i}", labels={NODEPOOL_LABEL: pool})))
        store.create(port_pod(PodDesc(f"p{i}", {mig("4g.40gb"): 1}, unschedulable=True,
                                      selector={NODEPOOL_LABEL: pool})))
    controller = PartitionerController(
        store, ClusterState(), MigSnapshotTaker(), Planner(new_framework(store)),
        Actuator(MigPartitioner(store)), PARTITIONING_MIG, is_mig_resource,
        pool_sharding=True, pool_backend="process")
    serial = metrics.PLAN_BACKEND.labels(backend="serial")
    before = serial.value
    controller.sync()
    assert controller.process_pending_pods() == 2
    assert controller._process_disabled and controller._worker_pool is None
    assert controller.plans[-1]["backends"] == {"pool-a": "serial", "pool-b": "serial"}
    assert serial.value == before + 2
