"""The watch-fed partitioner state and the sim kubelet
(nos_tpu_torch.controllers.partitioner.node_controller / pod_controller,
partitioning/core/state.py, nos_tpu_torch.sim.kubelet).

- ``SimCluster`` on random MIG and MPS clusters (the shapes of
  ``tests/test_torch_planner.py``'s random cases: nodes of 1-3 H100s,
  pods of every profile in two namespaces and priorities), stepped with
  pods finishing and deleted along the way: after every drain of a
  mode's state controllers, its ``ClusterState`` equals a whole sync of
  the store (every node with its bound pending and running pods, in
  list order; the bindings; the mode counts).
- The two state controllers against the reference's
  (nos_tpu/controllers/partitioner/node_controller.py, pod_controller.py)
  on one random sequence of node and pod writes (binds, phases, deletes,
  a node deleted, a pod bound to a node the state did not know): the
  same nodes, the same pods on each (the port keeps them in list order,
  the reference in arrival order), the same bindings and mode counts.
- The kubelet against the reference's on translated cases (one MIG node
  ↔ one v5e board, ``1g.10gb / 2g.20gb / 4g.40gb / 7g.80gb`` ↔ ``1x1 /
  1x2 / 2x2 / 2x4``): the same pods admitted and rejected.
"""
import random

import pytest

from nos_tpu.api.v1alpha1 import constants as jconstants
from nos_tpu.api.v1alpha1.labels import PARTITIONING_LABEL as JLABEL
from nos_tpu.controllers.partitioner.node_controller import StateNodeController as JNodeCtl
from nos_tpu.controllers.partitioner.pod_controller import StatePodController as JPodCtl
from nos_tpu.kube import controller as jctl
from nos_tpu.kube.store import KubeStore
from nos_tpu.partitioning.core import ClusterState as JClusterState
from nos_tpu.sim.kubelet import SimKubelet as JKubelet
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.partitioner.node_controller import add_state_controllers
from nos_tpu_torch.kube.controller import Manager, Request
from nos_tpu_torch.kube.store import NodeStore, NotFoundError, Pod
from nos_tpu_torch.partitioning.core import ClusterState
from nos_tpu_torch.sim.kubelet import SimKubelet
from tests.torch_planner_cases import (
    MIG_PROFILES,
    TO_TPU,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
)

MPS_PROFILES = ("10gb", "20gb", "40gb")


def whole_sync(store):
    state = ClusterState()
    by_node = store.pods_by_node()
    for node in store.list("Node", copy=False):
        state.update_node(node, list(by_node.get(node.name, ())))
    return state


def same_state(state, store):
    whole = whole_sync(store)
    assert state.read_view() == whole.read_view()
    assert state.bindings() == whole.bindings()
    for kind in ("mig", "mps"):
        assert state.is_partitioning_enabled(kind) == whole.is_partitioning_enabled(kind)


def _random_cluster(rng):
    cluster = SimCluster()
    for i in range(rng.randint(1, 5)):
        if rng.random() < 0.6:
            cluster.add_mig_node(f"m{i}", gpus=rng.randint(1, 3))
        else:
            cluster.add_mps_node(f"s{i}", gpus=rng.randint(1, 3))
    for j in range(rng.randint(5, 25)):
        if rng.random() < 0.6:
            request = {f"nvidia.com/mig-{rng.choice(MIG_PROFILES)}": 1}
        else:
            request = {f"nvidia.com/gpu-{rng.choice(MPS_PROFILES)}": 1}
        cluster.store.create(Pod(f"p{j:02d}", rng.choice(["a", "b"]), request=request,
                                 priority=rng.choice([0, 0, 1, 5])))
    return cluster


@pytest.mark.parametrize("seed", range(6))
def test_the_watch_fed_state_is_a_whole_sync_after_every_drain(seed):
    rng = random.Random(13000 + seed)
    cluster = _random_cluster(rng)
    feeds = {tuple(cluster._mig_feed): cluster.mig.cluster_state,
             tuple(cluster._mps_feed): cluster.mps.cluster_state}
    drain = cluster.manager.drain
    checked = []

    def checked_drain(names=None):
        ran = drain(names)
        state = feeds.get(tuple(names or ()))
        if state is not None:
            same_state(state, cluster.store)
            checked.append(ran)
        return ran

    cluster.manager.drain = checked_drain
    ran = set()
    try:
        for step in range(40):
            cluster.step()
            running = [p for p in cluster.store.list("Pod") if p.phase == "Running"]
            ran.update(p.name for p in running)
            if step % 8 == 7:
                for pod in rng.sample(running, min(2, len(running))):
                    if rng.random() < 0.5:
                        cluster.store.delete("Pod", pod.name, pod.namespace)
                    else:
                        cluster.store.patch_merge("Pod", pod.name, pod.namespace,
                                                  lambda p: setattr(p, "phase", "Succeeded"))
        assert len(checked) == 80 and sum(checked) > 0
        assert cluster.kubelet.admission_rejects == 0 and ran
    finally:
        cluster.close()


# ------------------------------------------------ the state controllers


def _ref_drain(controllers):
    """The reference's pump and worker bodies, run until nothing is due."""
    busy = True
    while busy:
        busy = False
        for c in controllers:
            while not c._event_queue.empty():
                c._dispatch(c._event_queue.get_nowait())
            while (req := c.queue.get(timeout=0)) is not None:
                busy = True
                try:
                    c.reconciler(req)
                finally:
                    c.queue.done(req)


def _ref_view(state, kinds=("tpu", "sharing")):
    view = state.read_view()
    return ({n: sorted(p.metadata.name for p in info.pods) for n, info in view.items()},
            {k.split("/")[1]: v for k, v in state._bindings.items()},
            [state.is_partitioning_enabled(k) for k in kinds])


def _port_view(state):
    view = state.read_view()
    return ({n: sorted(p.name for p in info.pods) for n, info in view.items()},
            {k.split("/")[1]: v for k, v in state.bindings().items()},
            [state.is_partitioning_enabled(k) for k in ("mig", "mps")])


@pytest.mark.parametrize("seed", range(6))
def test_the_state_controllers_keep_the_state_as_the_reference(seed):
    rng = random.Random(14000 + seed)
    jstore, tstore = KubeStore(), NodeStore()
    jstore.add_indexer("Pod", jconstants.INDEX_POD_NODE, lambda p: [p.spec.node_name])
    jstate, tstate = JClusterState(), ClusterState()
    jnode, jpod = JNodeCtl(jstore, jstate), JPodCtl(jstore, jstate)
    jcs = [jctl.Controller("state-node", jstore, jnode.reconcile, [jctl.Watch(
               "Node", predicate=lambda e: JLABEL in e.object.metadata.labels
               or e.type == "DELETED")]),
           jctl.Controller("state-pod", jstore, jpod.reconcile, [jctl.Watch("Pod")])]
    for c in jcs:
        c._event_queue = jstore.watch({w.kind for w in c.watches}, name=c.name)
    manager = Manager(tstore)
    add_state_controllers(manager, tstate)
    nodes = [NodeDesc(f"n{i}", gpus=rng.randint(1, 2), mode=rng.choice(["mig", "mps"]))
             for i in range(4)]
    for desc in nodes[:3]:
        jstore.create(ref_node(desc))
        tstore.create(port_node(desc))
    pods = [f"p{j}" for j in range(10)]
    for step in range(80):
        op = rng.random()
        name = rng.choice(pods)
        try:
            if op < 0.35:
                desc = PodDesc(name, {f"nvidia.com/mig-{rng.choice(MIG_PROFILES)}": 1},
                               ns=rng.choice(["a", "b"]), node=rng.choice(["", "n0", "n1",
                                                                             "n2", "n3"]),
                               phase=rng.choice(["Pending", "Running"]))
                jstore.create(ref_pod(desc))
                tstore.create(port_pod(desc))
            elif op < 0.55:
                ns, node = rng.choice(["a", "b"]), rng.choice(["n0", "n1", "n2", "n3"])

                def bind_ref(p):
                    p.spec.node_name = node

                jstore.patch_merge("Pod", name, ns, bind_ref)
                tstore.patch_merge("Pod", name, ns, lambda p: setattr(p, "node", node))
            elif op < 0.7:
                ns, phase = rng.choice(["a", "b"]), rng.choice(["Running", "Succeeded",
                                                               "Failed"])

                def phase_ref(p):
                    p.status.phase = phase

                jstore.patch_merge("Pod", name, ns, phase_ref)
                tstore.patch_merge("Pod", name, ns, lambda p: setattr(p, "phase", phase))
            elif op < 0.85:
                ns = rng.choice(["a", "b"])
                jstore.delete("Pod", name, ns)
                tstore.delete("Pod", name, ns)
            elif op < 0.93:
                desc = rng.choice(nodes)
                if jstore.try_get("Node", desc.name) is None:
                    jstore.create(ref_node(desc))
                    tstore.create(port_node(desc))
                else:
                    jstore.delete("Node", desc.name)
                    tstore.delete("Node", desc.name)
            else:
                desc = rng.choice(nodes)
                jstore.patch_labels("Node", desc.name, "", {"touched": str(step)})
                tstore.patch_labels("Node", desc.name, "", {"touched": str(step)})
        except (KeyError, ValueError, NotFoundError):
            pass
        if rng.random() < 0.4:
            _ref_drain(jcs)
            manager.drain()
            assert _port_view(tstate) == _ref_view(jstate)
    _ref_drain(jcs)
    manager.drain()
    assert _port_view(tstate) == _ref_view(jstate)
    same_state(tstate, tstore)


# ------------------------------------------------------------ the kubelet


@pytest.mark.parametrize("seed", range(10))
def test_the_kubelet_admits_and_rejects_as_the_reference(seed):
    rng = random.Random(15000 + seed)
    geometry = {0: {}}
    budget = 8
    for profile in rng.sample(MIG_PROFILES, len(MIG_PROFILES)):
        size = {"1g.10gb": 1, "2g.20gb": 2, "4g.40gb": 4, "7g.80gb": 8}[profile]
        n = rng.randint(0, budget // size)
        if n:
            geometry[0][profile] = n
            budget -= n * size
    desc = NodeDesc("n0")
    jstore, tstore = KubeStore(), NodeStore()
    jstore.create(ref_node(desc))
    tstore.create(port_node(desc))
    jk = JKubelet(jstore, geometry_fn=lambda node: {
        b: {TO_TPU[p]: n for p, n in prof.items()} for b, prof in geometry.items()})
    tk = SimKubelet(tstore, geometry_fn=lambda node: geometry)
    names = []
    for j in range(rng.randint(2, 6)):
        pod = PodDesc(f"p{j}", {f"nvidia.com/mig-{rng.choice(MIG_PROFILES)}": 1}, node="n0",
                      phase=rng.choice(["Pending", "Pending", "Running"]))
        jstore.create(ref_pod(pod))
        tstore.create(port_pod(pod))
        names.append(pod.name)
    for name in names:
        jk.reconcile(jctl.Request(name, "default"))
        tk.reconcile(Request(name, "default"))
    assert [tstore.get("Pod", n, "default").phase for n in names] == [
        jstore.get("Pod", n, "default").status.phase for n in names]
    assert tk.admission_rejects == jk.admission_rejects
