"""The threaded suite: every component on one store, in wall time.

``build_cluster`` with 4 MIG nodes of 8 H100s in two node pools and one
MPS node, about 30 pods of the four MIG profiles and three MPS slices, a
namespace under an ElasticQuota that borrows another's unused guarantee, a 2-member gang of whole
GPUs and a plain ``nvidia.com/gpu: 12`` pod that the multi-node expander
turns into a gang of two nodes: every pod Running, then
``SimCluster.check()``'s invariants hold on the store (the quotas' and
the gangs' among them), and the same description through the polled
``SimCluster`` places every pod too.
"""
import time

import pytest

from nos_tpu_torch.api.config import GpuPartitionerConfig, SchedulerConfig
from nos_tpu_torch.api.v1alpha1.elasticquota import ElasticQuota
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.cmd.cluster import build_cluster
from nos_tpu_torch.cmd.run import seed_node, seed_pod
from nos_tpu_torch.controllers.partitioner.multinode import MULTINODE_ROLE_LABEL
from nos_tpu_torch.kube.store import PodPhase

GB = "nos.nebuly.com/gpu-memory"
NODES = ([{"name": f"mig-{i}", "partitioning": "mig", "nodepool": f"pool-{i // 2}"}
          for i in range(4)] + [{"name": "mps-0", "partitioning": "mps"}])
PODS = ([{"name": f"small-{i}", "mig": "1g.10gb"} for i in range(6)]
        + [{"name": f"mid-{i}", "mig": "2g.20gb"} for i in range(4)]
        + [{"name": f"big-{i}", "mig": "3g.40gb", "namespace": "team-a"} for i in range(6)]
        + [{"name": f"whole-{i}", "mig": "7g.80gb"} for i in range(2)]
        + [{"name": f"shared-{i}", "mps": gb} for i, gb in enumerate(
            ["10gb", "10gb", "20gb", "20gb", "40gb", "40gb", "20gb", "10gb"])]
        + [{"name": f"gang-{i}", "mig": "7g.80gb", "gang": "pair", "gangSize": 2}
           for i in range(2)]
        + [{"name": "wide", "gpus": 12}])
# team-a asks 6 x 40 GB with 160 guaranteed: it borrows 80 GB of
# team-b's unused guarantee
QUOTA = ElasticQuota("quota", "team-a", {GB: 160}, {GB: 320})
LENDER = ElasticQuota("quota", "team-b", {GB: 160})


def _wait_running(pods_fn, deadline_s):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        pods = pods_fn()
        if pods and all(p.phase == PodPhase.RUNNING for p in pods):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def suite():
    cluster = build_cluster(
        partitioner_config=GpuPartitionerConfig(batch_window_timeout_seconds=1.0,
                                                batch_window_idle_seconds=0.05),
        scheduler_config=SchedulerConfig(retry_seconds=0.2))
    cluster.store.create(QUOTA)
    cluster.store.create(LENDER)
    for spec in NODES:
        cluster.add_node(seed_node(spec))
    cluster.start()
    yield cluster
    cluster.stop()


def test_the_threaded_suite_places_every_pod(suite):
    for spec in PODS:
        suite.store.create(seed_pod(spec))
    assert _wait_running(suite.pods, 60.0), {
        p.namespaced_name: (p.phase, p.node, p.unschedulable_message)
        for p in suite.pods() if p.phase != PodPhase.RUNNING}
    assert suite.wait_idle(timeout=20.0)
    pods = suite.pods()
    # the expander's pod became a gang of two members on two nodes of one pool
    wide = [p for p in pods if p.name.startswith("wide")]
    assert len(wide) == 2 and {p.labels[MULTINODE_ROLE_LABEL] for p in wide} == {
        "leader", "worker"}
    assert len({p.node for p in wide}) == 2
    pair = [p for p in pods if p.name.startswith("gang-")]
    pools = {suite.store.get("Node", p.node).labels["cloud.google.com/gke-nodepool"]
             for p in pair}
    assert len(pools) == 1
    quota = suite.store.get("ElasticQuota", "quota", "team-a")
    assert QUOTA.min[GB] < quota.used[GB] <= QUOTA.max[GB]  # borrowed, within max
    checks = suite.check()
    assert all(checks.values()), checks
    assert suite.partitioner.plans_applied >= 1 and suite.partitioner.mps.plans_applied >= 1
    reconciles = suite.reconciles()
    assert reconciles["scheduler"] > 0 and reconciles["sim-kubelet"] >= len(pods)


def test_the_polled_loop_places_the_same_description():
    cluster = SimCluster()
    cluster.store.create(QUOTA)
    cluster.store.create(LENDER)
    for spec in NODES:
        node = seed_node(spec)
        pool = node.labels.get("cloud.google.com/gke-nodepool")
        if spec["partitioning"] == "mig":
            cluster.add_mig_node(node.name, pool=pool)
        else:
            cluster.add_mps_node(node.name, pool=pool)
    for spec in PODS:
        cluster.store.create(seed_pod(spec))
    assert cluster.run_until_idle(2000)
    assert all(p.phase == PodPhase.RUNNING for p in cluster.store.list("Pod"))
    assert all(cluster.check().values())


def test_the_suite_holds_under_concurrent_writes(suite):
    """Twelve writer threads (more than the cores) create pods and delete
    some while every component runs, with the interpreter switching
    threads every 10 us: the pods left all run and the invariants hold
    (a lost update in a controller's shared state, the partitioner's
    batch or its memos, would leave a pod pending or break a check)."""
    import sys
    import threading

    errors = []

    def writer(w):
        try:
            for i in range(6):
                pod = suite.store.create(seed_pod({"name": f"w{w}-{i}", "mig": "1g.10gb"}))
                if i % 3 == 2:
                    suite.store.delete("Pod", pod.name, pod.namespace)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(interval)
    assert len(suite.pods()) == 12 * 4
    assert _wait_running(suite.pods, 60.0), {
        p.namespaced_name: (p.phase, p.node, p.unschedulable_message)
        for p in suite.pods() if p.phase != PodPhase.RUNNING}
    assert suite.wait_idle(timeout=20.0)
    checks = suite.check()
    assert all(checks.values()), checks
