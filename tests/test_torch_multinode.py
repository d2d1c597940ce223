"""Multi-node gangs: the expander (nos_tpu_torch.controllers.partitioner.
multinode), the node-pool pin (MultinodeFilter) and the topology score,
against nos_tpu's multihost expander and ICI plugins, then the whole
flow on SimCluster.

Exact on one-GPU nodes, where one v5e board (8 chips, a 2x4) stands for
one H100 (8 memory slices, a 7g.80gb): ``google.com/tpu: 8N`` expands to
the smallest v5e shape, N hosts of one board each for N = 2, 4, 8, 16 and
32 (4x4 … 16x16), and ``nvidia.com/gpu: N`` to N members of one whole
GPU each. The cases are tests/controllers/test_multihost.py's expansion,
idempotency, garbage-collection and filter tests (the reference's filter
with F6 repaired, ``RefMultihostIciFilter``), and its admission
mutation against the port's admission hook (the wire webhook waits for
the kube substrate's slice). The shape annotation is the reference's
topology (``4x4``) and the port's ``<members>x<G>`` (``2x1``).

On the port alone, the H100 meaning's differences: ``ceil(N / G)``
members (N 3 on one-GPU nodes gives 3 members where the reference gives
4; N 24 on 8-GPU nodes gives 3 members of 8 GPUs), and no size beyond
which a request is left alone (no torus bounds the count).

Then tests/integration/test_multihost_e2e.py's three flows as SimCluster
runs on four one-GPU MIG nodes of one pool: a fragmented fleet re-carved
for a 4-GPU gang that binds whole, one member a node; the leader's
deletion garbage-collecting its workers and Service; and a borrowing
gang preempted whole by a quota within its min. The gang invariants
(``SimCluster.check_gangs``) hold at every step.
"""
import random

import pytest

from nos_tpu.controllers.partitioner import multihost as jmh
from nos_tpu.kube.controller import Request
from nos_tpu.kube.store import KubeStore
from nos_tpu.scheduler import framework as jfw
from nos_tpu.scheduler.plugins import gang as jgang
from nos_tpu.scheduler.plugins import topology as jtopo
from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.partitioner import multinode as tmn
from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.scheduler import framework as tfw
from nos_tpu_torch.scheduler.plugins import gang as tgang
from nos_tpu_torch.scheduler.plugins import topology as ttopo
from tests.torch_planner_cases import (
    MIG_PROFILES,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
    to_port_resource,
    to_ref_resource,
)
from tests.torch_quota_cases import RefMultihostIciFilter

TPU = "google.com/tpu"
GPU = "nvidia.com/gpu"
WHOLE = "nvidia.com/mig-7g.80gb"
SHAPES = {2: "4x4", 4: "4x8", 8: "8x8", 16: "8x16", 32: "16x16"}


def stores_with_one_node(gpus=1):
    jstore, tstore = KubeStore(), NodeStore()
    desc = NodeDesc("tpu-0", gpus=gpus)
    jstore.create(ref_node(desc))
    tstore.create(port_node(desc))
    return jstore, tstore


def expand_both(jstore, tstore, name, ns="default"):
    jmh.MultihostExpander(jstore).reconcile(Request(name=name, namespace=ns))
    tmn.MultinodeExpander(tstore).step()


def same_gang(jstore, tstore, ns="default"):
    """Every pod on both sides: labels, the shape annotation's presence,
    request (in the port's names), owner, hostname, subdomain, env."""
    def ref_view(p):
        c = p.spec.containers[0]
        return (p.metadata.name, dict(p.metadata.labels),
                jmh.MULTIHOST_TOPOLOGY_ANNOTATION in p.metadata.annotations,
                {to_port_resource(k): v for k, v in c.requests.items()},
                [(r.kind, r.name) for r in p.metadata.owner_references],
                p.spec.hostname, p.spec.subdomain, dict(c.env))

    def port_view(p):
        return (p.name, dict(p.labels), tmn.MULTINODE_TOPOLOGY_ANNOTATION in p.annotations,
                {k: v for k, v in p.request.items()},
                [(p.owner.kind, p.owner.name)] if p.owner else [],
                p.hostname, p.subdomain, dict(p.env))

    want = sorted(ref_view(p) for p in jstore.list("Pod", namespace=ns))
    got = sorted(port_view(p) for p in tstore.list("Pod", namespace=ns))
    for w, g in zip(want, got):
        # the reference's plain chips are the port's plain GPUs, 8 to 1
        if TPU in w[3]:
            w[3][GPU] = w[3].pop(TPU) // 8
    assert got == want
    return got


def test_names_match_the_reference():
    assert tmn.MULTINODE_TOPOLOGY_ANNOTATION == jmh.MULTIHOST_TOPOLOGY_ANNOTATION
    assert tmn.MULTINODE_ROLE_LABEL == jmh.MULTIHOST_ROLE_LABEL
    assert (tmn.ROLE_LEADER, tmn.ROLE_WORKER) == (jmh.ROLE_LEADER, jmh.ROLE_WORKER)
    assert ttopo.NODEPOOL_LABEL == jtopo.GKE_NODEPOOL_LABEL
    from nos_tpu.parallel import distributed as jdist

    assert tmn.gang_member_env("big", "ml", 2, 4) == jdist.gang_member_env("big", "ml", 2, 4)


# ------------------------------------------------------------ TestExpansion

@pytest.mark.parametrize("gpus", sorted(SHAPES))
def test_oversized_request_becomes_gang(gpus):
    jstore, tstore = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("big", {TPU: 8 * gpus})))
    tstore.create(port_pod(PodDesc("big", {GPU: gpus})))
    expand_both(jstore, tstore, "big")
    same_gang(jstore, tstore)
    leader = tstore.get("Pod", "big", "default")
    assert leader.labels[tgang.GANG_NAME_LABEL] == "big"
    assert leader.labels[tgang.GANG_SIZE_LABEL] == str(gpus)
    assert leader.labels[tmn.MULTINODE_ROLE_LABEL] == tmn.ROLE_LEADER
    assert leader.annotations[tmn.MULTINODE_TOPOLOGY_ANNOTATION] == f"{gpus}x1"
    assert jstore.get("Pod", "big", "default").metadata.annotations[
        jmh.MULTIHOST_TOPOLOGY_ANNOTATION] == SHAPES[gpus]
    assert leader.request == {WHOLE: 1}
    worker = tstore.get("Pod", "big-w1", "default")
    assert worker.labels[tmn.MULTINODE_ROLE_LABEL] == tmn.ROLE_WORKER
    assert worker.owner.name == "big" and worker.owner.uid == leader.uid
    assert worker.env[tmn.PROCESS_ID_ENV] == "1"
    assert len(tstore.list("Pod")) == gpus
    service = tstore.get("Service", "big", "default")
    assert service.selector == {tgang.GANG_NAME_LABEL: "big"}
    assert service.ports == {"coordinator": tmn.DEFAULT_COORDINATOR_PORT}


def test_single_node_request_untouched():
    jstore, tstore = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("small", {TPU: 8})))
    tstore.create(port_pod(PodDesc("small", {GPU: 1})))
    expand_both(jstore, tstore, "small")
    same_gang(jstore, tstore)
    assert tstore.get("Pod", "small", "default").request == {GPU: 1}
    assert len(tstore.list("Pod")) == 1


def test_slice_request_untouched():
    jstore, tstore = stores_with_one_node()
    for store, build in ((jstore, ref_pod), (tstore, port_pod)):
        store.create(build(PodDesc("sliced", {"nvidia.com/mig-4g.40gb": 1})))
    expand_both(jstore, tstore, "sliced")
    same_gang(jstore, tstore)
    assert tgang.GANG_NAME_LABEL not in tstore.get("Pod", "sliced", "default").labels


def test_reconcile_is_idempotent():
    jstore, tstore = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("big", {TPU: 32})))
    tstore.create(port_pod(PodDesc("big", {GPU: 4})))
    expand_both(jstore, tstore, "big")
    expand_both(jstore, tstore, "big")  # the leader path: only ensures workers
    assert len(same_gang(jstore, tstore)) == 4
    assert tstore.get("Pod", "big", "default").request == {WHOLE: 1}


def test_worker_gc_when_leader_gone():
    jstore, tstore = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("big", {TPU: 16})))
    tstore.create(port_pod(PodDesc("big", {GPU: 2})))
    expand_both(jstore, tstore, "big")
    for store in (jstore, tstore):
        store.delete("Pod", "big", "default")
    expand_both(jstore, tstore, "big-w1")
    assert jstore.try_get("Pod", "big-w1", "default") is None
    assert tstore.try_get("Pod", "big-w1", "default") is None
    assert tstore.try_get("Service", "big", "default") is None


def test_worker_kept_while_leader_alive():
    jstore, tstore = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("big", {TPU: 16})))
    tstore.create(port_pod(PodDesc("big", {GPU: 2})))
    expand_both(jstore, tstore, "big")
    expand_both(jstore, tstore, "big-w1")
    assert tstore.try_get("Pod", "big-w1", "default") is not None
    same_gang(jstore, tstore)


# ------------------------------------------------------------ the H100 meaning

@pytest.mark.parametrize("gpus,per_node,members", [(3, 1, 3), (24, 8, 3), (9, 8, 2),
                                                   (512, 8, 64)])
def test_members_are_ceil_of_gpus_over_gpus_per_node(gpus, per_node, members):
    _, tstore = stores_with_one_node(gpus=per_node)
    tstore.create(port_pod(PodDesc("big", {GPU: gpus}, ns="ml")))
    tmn.MultinodeExpander(tstore).step()
    leader = tstore.get("Pod", "big", "ml")
    assert leader.labels[tgang.GANG_SIZE_LABEL] == str(members)
    assert leader.annotations[tmn.MULTINODE_TOPOLOGY_ANNOTATION] == f"{members}x{per_node}"
    assert leader.request == {WHOLE: per_node}
    pods = tstore.list("Pod", namespace="ml")
    assert len(pods) == members
    assert sorted(int(p.env[tmn.PROCESS_ID_ENV]) for p in pods) == list(range(members))


def test_reference_gives_four_hosts_for_three_boards():
    """The difference pinned: 24 chips fit no v5e shape under 4x8, so the
    reference asks 4 hosts where the port asks 3 GPUs."""
    jstore, _ = stores_with_one_node()
    jstore.create(ref_pod(PodDesc("big", {TPU: 24})))
    jmh.MultihostExpander(jstore).reconcile(Request(name="big", namespace="default"))
    assert jstore.get("Pod", "big", "default").metadata.labels[jgang.GANG_SIZE_LABEL] == "4"


def test_no_mig_fleet_no_expansion():
    tstore = NodeStore()
    tstore.create(port_node(NodeDesc("s0", gpus=8, mode="mps")))
    tstore.create(port_pod(PodDesc("big", {GPU: 16})))
    tmn.MultinodeExpander(tstore).step()
    assert tstore.get("Pod", "big", "default").request == {GPU: 16}


# ------------------------------------------------------------ admission

def test_admission_expands_at_create_as_the_reference_webhook_does():
    jstore, tstore = stores_with_one_node()
    expander = tmn.register_multinode_admission(tstore)
    wire = {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "big", "namespace": "ml", "labels": {"team": "research"}},
            "spec": {"containers": [{"name": "main", "env": [{"name": "MODE",
                                                             "value": "train"}],
                                     "resources": {"requests": {TPU: "32"},
                                                   "limits": {TPU: "32"}}}]},
            "status": {"phase": "Pending"}}
    ops = {op["path"]: op["value"] for op in jmh.admission_mutate_pod(wire, jstore)}
    created = tstore.create(Pod("big", "ml", request={GPU: 4}, labels={"team": "research"},
                                env={"MODE": "train"}))
    assert expander.expansions == 1
    assert created.labels == ops["/metadata/labels"]
    assert tmn.MULTINODE_TOPOLOGY_ANNOTATION in ops["/metadata/annotations"]
    assert tmn.MULTINODE_TOPOLOGY_ANNOTATION in created.annotations
    main = ops["/spec/containers"][0]
    assert created.env == {e["name"]: e["value"] for e in main["env"]}
    assert {to_port_resource(k): int(v) for k, v in main["resources"]["requests"].items()} == {
        "nvidia.com/mig-7g.80gb": 1} == created.request
    assert (created.hostname, created.subdomain) == (ops["/spec/hostname"],
                                                     ops["/spec/subdomain"])
    # the workers come with the next step, as with the reference's controller
    assert len(tstore.list("Pod", namespace="ml")) == 1
    expander.step()
    assert len(tstore.list("Pod", namespace="ml")) == 4


def test_small_pod_is_not_mutated():
    jstore, tstore = stores_with_one_node()
    tmn.register_multinode_admission(tstore)
    created = tstore.create(Pod("small", "ml", request={GPU: 1}))
    assert created.request == {GPU: 1} and not created.labels


# ------------------------------------------------------------ MultihostIciFilter

def _member_desc(name, gang="g1", node=""):
    return PodDesc(name, {WHOLE: 1}, node=node, phase="Running" if node else "Pending",
                   labels={tgang.GANG_NAME_LABEL: gang, tgang.GANG_SIZE_LABEL: "2"},
                   annotations={tmn.MULTINODE_TOPOLOGY_ANNOTATION: "2x1"})


def _pool_stores():
    jstore, tstore = KubeStore(), NodeStore()
    for name, pool in (("a1", "pool-a"), ("b1", "pool-b")):
        desc = NodeDesc(name, labels={ttopo.NODEPOOL_LABEL: pool})
        jstore.create(ref_node(desc))
        tstore.create(port_node(desc))
    return jstore, tstore


def _filter_both(jfilter, tfilter, jstore, tstore, pod, node):
    want = jfilter.filter(jfw.CycleState(), ref_pod(pod), jfw.NodeInfo(
        node=jstore.get("Node", node)))
    got = tfilter.filter(tfw.CycleState(), port_pod(pod), tfw.NodeInfo(
        node=tstore.get("Node", node)))
    assert got.success == want.success
    assert got.message == want.message.replace("multi-host slice", "multi-node gang")
    return got


def test_members_pinned_to_first_pool():
    jstore, tstore = _pool_stores()
    for store, build in ((jstore, ref_pod), (tstore, port_pod)):
        store.create(build(_member_desc("m0", node="a1")))
    jf, tf = RefMultihostIciFilter(jstore), ttopo.MultinodeFilter(tstore)
    assert _filter_both(jf, tf, jstore, tstore, _member_desc("m1"), "a1").success
    blocked = _filter_both(jf, tf, jstore, tstore, _member_desc("m1"), "b1")
    assert not blocked.success and "pinned" in blocked.message


def test_permit_reserved_members_pin_too():
    jstore, tstore = _pool_stores()
    jg, tg = jgang.GangScheduling(jstore), tgang.GangScheduling(tstore)
    m0 = _member_desc("m0")
    jstore.create(ref_pod(m0))
    tstore.create(port_pod(m0))
    jg.permit(jfw.CycleState(), ref_pod(m0), "a1")
    tg.permit(tfw.CycleState(), port_pod(m0), "a1")
    blocked = _filter_both(RefMultihostIciFilter(jstore, jg),
                           ttopo.MultinodeFilter(tstore, tg), jstore, tstore,
                           _member_desc("m1"), "b1")
    assert not blocked.success


def test_non_multinode_pods_unconstrained():
    jstore, tstore = _pool_stores()
    pod = PodDesc("plain", {"nvidia.com/mig-4g.40gb": 1})
    assert _filter_both(RefMultihostIciFilter(jstore), ttopo.MultinodeFilter(tstore),
                        jstore, tstore, pod, "b1").success


# ------------------------------------------------------------ topology score

@pytest.mark.parametrize("seed", range(20))
def test_topology_score_matches_the_reference(seed):
    """Exact fit, the used share of the node's slices and the gang's pool,
    on random advertised slices, placed pods and gangs."""
    rng = random.Random(9800 + seed)
    jstore, tstore = KubeStore(), NodeStore()
    nodes = []
    for i in range(rng.randint(1, 4)):
        desc = NodeDesc(f"n{i}", gpus=2, labels={ttopo.NODEPOOL_LABEL: rng.choice("ab")}
                        if rng.random() < 0.8 else {}, mode=rng.choice(["mig", "mig", "mps"]))
        jn, tn = ref_node(desc), port_node(desc)
        if desc.mode == "mig":
            advertised = {f"nvidia.com/mig-{p}": rng.randint(0, 2)
                          for p in rng.sample(MIG_PROFILES, 2)}
        else:
            advertised = {"nvidia.com/gpu-20gb": rng.randint(0, 3)}
        jn.status.allocatable.update({to_ref_resource(k): v for k, v in advertised.items()})
        tn.allocatable.update(advertised)
        jstore.create(jn)
        tstore.create(tn)
        nodes.append((desc, advertised))
    placed = []
    for j in range(rng.randint(0, 5)):
        desc, advertised = rng.choice(nodes)
        names = [k for k, v in advertised.items() if v]
        if not names:
            continue
        labels = ({tgang.GANG_NAME_LABEL: "job", tgang.GANG_SIZE_LABEL: "3"}
                  if rng.random() < 0.5 else {})
        placed.append(PodDesc(f"r{j}", {rng.choice(names): 1}, node=desc.name,
                              phase="Running", labels=labels))
    for p in placed:
        jstore.create(ref_pod(p))
        tstore.create(port_pod(p))
    request = rng.choice([{f"nvidia.com/mig-{rng.choice(MIG_PROFILES)}": 1},
                          {"nvidia.com/gpu-20gb": 1}, {"cpu": 1}])
    pod = PodDesc("p", request, labels={tgang.GANG_NAME_LABEL: "job",
                                        tgang.GANG_SIZE_LABEL: "3"}
                  if rng.random() < 0.6 else {})
    jscore, tscore = jtopo.IciTopologyScoring(jstore), ttopo.TopologyScoring(tstore)
    for desc, _ in nodes:
        jinfo = jfw.NodeInfo(node=jstore.get("Node", desc.name),
                             pods=[p for p in jstore.list("Pod")
                                   if p.spec.node_name == desc.name])
        tinfo = tfw.NodeInfo(node=tstore.get("Node", desc.name),
                             pods=[p for p in tstore.list("Pod") if p.node == desc.name])
        assert (tscore.score(tfw.CycleState(), port_pod(pod), tinfo)
                == jscore.score(jfw.CycleState(), ref_pod(pod), jinfo))


# ------------------------------------------------------------ SimCluster flows

def pool_cluster(**kw):
    cluster = SimCluster(**kw)
    for i in range(4):
        cluster.add_mig_node(f"h{i}", gpus=1, pool="pool-a")
    return cluster


def run(cluster, steps=600):
    broken = []

    def watch():
        checks = cluster.check_gangs()
        if not all(checks.values()):
            broken.append((cluster.steps, checks))

    assert cluster.run_until_idle(steps, on_step=watch)
    assert broken == []


def gang_members(cluster, ns="ml", gang="big"):
    return [p for p in cluster.store.list("Pod", namespace=ns)
            if p.labels.get(tgang.GANG_NAME_LABEL) == gang]


def test_oversized_request_runs_as_full_gang():
    cluster = pool_cluster()
    for i in range(4):
        cluster.store.create(Pod(f"small-{i}", "ml", request={"nvidia.com/mig-4g.40gb": 1}))
    run(cluster)
    assert all(p.phase == PodPhase.RUNNING for p in cluster.store.list("Pod"))
    for i in range(4):
        cluster.store.delete("Pod", f"small-{i}", "ml")
    plans_before = cluster.mig.plans_applied
    cluster.store.create(Pod("big", "ml", request={GPU: 4}))
    run(cluster)
    members = gang_members(cluster)
    leader = cluster.store.get("Pod", "big", "ml")
    assert leader.annotations[tmn.MULTINODE_TOPOLOGY_ANNOTATION] == "4x1"
    assert leader.request == {WHOLE: 1}
    assert len(members) == 4 and all(m.phase == PodPhase.RUNNING for m in members)
    nodes = {m.node for m in members}
    assert len(nodes) == 4  # one GPU a member
    for node in nodes:  # every host re-carved to a whole-GPU instance
        assert cluster.pool.geometry(node) == {0: {"7g.80gb": 1}}
    assert cluster.mig.plans_applied > plans_before
    assert all(cluster.check().values()), cluster.check()


def test_leader_delete_garbage_collects_workers():
    cluster = pool_cluster()
    cluster.store.create(Pod("big", "ml", request={GPU: 4}))
    cluster.step()
    assert len(gang_members(cluster)) == 4
    cluster.store.delete("Pod", "big", "ml")
    run(cluster)
    assert cluster.store.list("Pod", namespace="ml") == []
    assert cluster.store.list("Service") == []


def test_preempting_gang_frees_all_gpus():
    cluster = pool_cluster()
    cluster.add_quota("team-a", {RESOURCE_GPU_MEMORY: 0}, max={RESOURCE_GPU_MEMORY: 320})
    cluster.add_quota("team-b", {RESOURCE_GPU_MEMORY: 320}, max={RESOURCE_GPU_MEMORY: 320})
    cluster.store.create(Pod("big", "team-a", request={GPU: 4}))
    run(cluster)
    members = gang_members(cluster, "team-a")
    assert len(members) == 4 and all(m.phase == PodPhase.RUNNING for m in members)
    for i in range(4):
        cluster.store.create(Pod(f"claim-{i}", "team-b", request={WHOLE: 1}))
    run(cluster)
    team_b = cluster.store.list("Pod", namespace="team-b")
    assert sum(p.phase == PodPhase.RUNNING for p in team_b) == 4
    assert [p for p in cluster.store.list("Pod", namespace="team-a")
            if p.phase == PodPhase.RUNNING] == []
    evicted = [v["pod"] for r in cluster.scheduler.preemptions for v in r["victims"]]
    assert sorted(evicted) == sorted(f"team-a/{m.name}" for m in members)
    assert all(cluster.check().values()), cluster.check()
