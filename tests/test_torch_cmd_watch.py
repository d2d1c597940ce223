"""The components' watches against the reference's builders.

Every component is built twice on a manager that is never started: with
the reference's builders (``nos_tpu/cmd/``) on a ``KubeStore`` and with
the port's (``nos_tpu_torch/cmd/``) on a ``NodeStore``, both stores
holding the same translated description (``tests/torch_planner_cases.py``:
a v5e node of 8 chips a GPU is an H100 node, ``tpu`` / ``sharing`` are
``mig`` / ``mps``). The controllers' names match under the translation
(``tpuagent-*`` is ``migagent-*``, ``sharingagent-*`` ``mpsagent-*``,
``multihost-expander`` ``multinode-expander``, ``partitioner-tpu`` /
``-sharing`` ``partitioner-mig`` / ``-mps``, and the reference's one
``state-node`` / ``state-pod`` pair is the port's pair a mode), and so do
their watches' kinds. A seeded list of events (pods pending, bound,
Succeeded, Failed and deleted; foreign pods; nodes with and without the
partitioning label; annotation changes; quotas; ModelServings; config
maps; a deleted gang leader) goes through both sides' predicates and
mappers, which give the same requests. Nothing of the reference's
process-wide state is written: its managers never start and no cycle
runs.
"""
import random

import pytest

from nos_tpu.api.config import v1alpha1 as jcfg
from nos_tpu.api.v1alpha1 import elasticquota as jeq
from nos_tpu.api.v1alpha1 import modelserving as jms
from nos_tpu.cmd.autoscaler import build_autoscaler as j_build_autoscaler
from nos_tpu.cmd.operator import build_operator as j_build_operator
from nos_tpu.cmd.partitioner import build_partitioner as j_build_partitioner
from nos_tpu.cmd.scheduler import build_scheduler as j_build_scheduler
from nos_tpu.cmd.sharingagent import build_sharingagent as j_build_sharingagent
from nos_tpu.cmd.tpuagent import build_tpuagent as j_build_tpuagent
from nos_tpu.device import SimDevicePlugin as JSimDevicePlugin
from nos_tpu.device import SimDevicePool, SimPodResourcesClient as JSimPodResources
from nos_tpu.device import SimTpuDeviceClient, TpuClient
from nos_tpu.device.sharing import SharedSliceClient as JSharedSliceClient
from nos_tpu.kube import objects as jobj
from nos_tpu.kube.controller import Manager as JManager
from nos_tpu.kube.store import KubeStore
from nos_tpu.kube.store import WatchEvent as JWatchEvent
from nos_tpu_torch.api.config import GpuPartitionerConfig
from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.v1alpha1.modelserving import ModelServing, ModelServingSpec
from nos_tpu_torch.cmd.autoscaler import build_autoscaler
from nos_tpu_torch.cmd.migagent import build_migagent, sim_devices
from nos_tpu_torch.cmd.mpsagent import build_mpsagent
from nos_tpu_torch.cmd.operator import build_operator
from nos_tpu_torch.cmd.partitioner import build_partitioner
from nos_tpu_torch.cmd.scheduler import build_scheduler
from nos_tpu_torch.device.sharing import SharedSliceClient
from nos_tpu_torch.kube import store as tstore
from nos_tpu_torch.kube.controller import Manager
from torch_planner_cases import NodeDesc, PodDesc, port_node, port_pod, ref_node, ref_pod

GANG = "nos.nebuly.com/gang"
ROLE = "nos.nebuly.com/multihost-role"
SERVING = "nos.nebuly.com/model-serving"
RESERVED = "nos.nebuly.com/reserved-for"
SEED = 22

# the reference's controller name → the port's
NAMES = {"state-node": ("state-node-mig", "state-node-mps"),
         "state-pod": ("state-pod-mig", "state-pod-mps"),
         "multihost-expander": ("multinode-expander",),
         "partitioner-tpu": ("partitioner-mig",),
         "partitioner-sharing": ("partitioner-mps",),
         "tpuagent-reporter-n1": ("migagent-reporter-n1",),
         "tpuagent-actuator-n1": ("migagent-actuator-n1",),
         "sharingagent-reporter-s1": ("mpsagent-reporter-s1",)}

NODES = [NodeDesc("n1", gpus=1, free={0: {"1g.10gb": 2}}),
         NodeDesc("gpu-0", gpus=2, labels={"cloud.google.com/gke-nodepool": "a"}),
         NodeDesc("s1", gpus=1, mode="mps", free={0: {"20gb": 2}}),
         NodeDesc("drain", gpus=1, annotations={RESERVED: "default/big"})]

PODS = [PodDesc("pending", {"nvidia.com/mig-1g.10gb": 1}, unschedulable=True),
        PodDesc("fresh", {"nvidia.com/gpu-20gb": 1}),
        PodDesc("foreign", {"nvidia.com/mig-1g.10gb": 1}),
        PodDesc("bound", {"nvidia.com/mig-1g.10gb": 1}, node="n1"),
        PodDesc("running", {"nvidia.com/mig-1g.10gb": 1}, node="n1", phase="Running"),
        PodDesc("done", {"nvidia.com/gpu-20gb": 1}, node="s1", phase="Succeeded"),
        PodDesc("crashed", {"nvidia.com/mig-1g.10gb": 1}, node="gpu-0", phase="Failed"),
        PodDesc("a-job", {"nvidia.com/mig-2g.20gb": 1}, ns="team-a"),
        PodDesc("b-job", {"nvidia.com/mig-2g.20gb": 1}, ns="team-b", node="gpu-0",
                phase="Running"),
        PodDesc("chat-replica-0", {"nvidia.com/mig-7g.80gb": 1},
                labels={SERVING: "default.chat", GANG: "chat-replica-0"}),
        PodDesc("lead", {"nvidia.com/mig-7g.80gb": 8}, labels={GANG: "lead", ROLE: "leader"}),
        PodDesc("lead-w1", {"nvidia.com/mig-7g.80gb": 8}, labels={GANG: "lead", ROLE: "worker"})]
QUOTAS = [(ElasticQuota("quota", "team-a", {"nos.nebuly.com/gpu-memory": 40}),
           jeq.ElasticQuota(metadata=jobj.ObjectMeta(name="quota", namespace="team-a"),
                            spec=jeq.ElasticQuotaSpec({"nos.nebuly.com/tpu-memory": 40}))),
          (CompositeElasticQuota("ceq", "default", ["team-b", "team-c"],
                                 {"nos.nebuly.com/gpu-memory": 80}),
           jeq.CompositeElasticQuota(
               metadata=jobj.ObjectMeta(name="ceq", namespace="default"),
               spec=jeq.CompositeElasticQuotaSpec(["team-b", "team-c"],
                                                  {"nos.nebuly.com/tpu-memory": 80})))]


def _pair_pod(desc):
    port, ref = port_pod(desc), ref_pod(desc)
    port.scheduler_name = "default-scheduler" if desc.name == "foreign" else "nos-scheduler"
    ref.spec.scheduler_name = port.scheduler_name
    if desc.name == "lead-w1":
        port.owner = tstore.OwnerReference("Pod", "lead", "", True)
        ref.metadata.owner_references = [jobj.OwnerReference("Pod", "lead", "", True)]
    return port, ref


def _pairs():
    """(port object, reference object) of every object in the description."""
    pairs = [(port_node(d), ref_node(d)) for d in NODES]
    pairs.append((tstore.Node("plain"), jobj.Node(metadata=jobj.ObjectMeta(name="plain"))))
    pairs += [_pair_pod(d) for d in PODS]
    pairs += QUOTAS
    pairs.append((ModelServing("chat", spec=ModelServingSpec(model="chat")),
                  jms.ModelServing(metadata=jobj.ObjectMeta(name="chat", namespace="default"),
                                   spec=jms.ModelServingSpec(model="chat"))))
    pairs.append((tstore.ConfigMap("nos-device-plugin-config", "default", {"s1-x": "{}"}),
                  jobj.ConfigMap(metadata=jobj.ObjectMeta(name="nos-device-plugin-config",
                                                          namespace="default"),
                                 data={"s1-x": "{}"})))
    return pairs


def _components(pairs):
    """The port's and the reference's managers, every component built."""
    tstore_, jstore = tstore.NodeStore(), KubeStore()
    port, ref = Manager(tstore_), JManager(store=jstore)
    build_operator(port)
    build_partitioner(port, GpuPartitionerConfig())
    build_scheduler(port)
    build_autoscaler(port)
    build_migagent(port, "n1", *sim_devices(port, "n1"))
    build_mpsagent(port, "s1", SharedSliceClient(tstore_))
    j_build_operator(ref)
    j_build_partitioner(ref, jcfg.GpuPartitionerConfig(forecast_enabled=False))
    j_build_scheduler(ref)
    j_build_autoscaler(ref)
    pool = SimDevicePool()
    j_build_tpuagent(ref, "n1", TpuClient(SimTpuDeviceClient(pool),
                                          JSimPodResources(jstore, pool.get)),
                     JSimDevicePlugin(jstore, pool))
    j_build_sharingagent(ref, "s1", JSharedSliceClient(jstore))
    for port_obj, ref_obj in pairs:
        tstore_.create(port_obj)
        jstore.create(ref_obj)
    return port, ref


@pytest.fixture(scope="module")
def built():
    pairs = _pairs()
    return _components(pairs), pairs


def _port_names(ref_name):
    return NAMES.get(ref_name, (ref_name,))


def test_the_controllers_and_their_watch_kinds_match(built):
    (port, ref), _ = built
    port_by_name = {c.name: c for c in port.controllers}
    matched = set()
    for jc in ref.controllers:
        for name in _port_names(jc.name):
            assert name in port_by_name, name
            assert [w.kind for w in port_by_name[name].watches] == [w.kind for w in jc.watches]
            matched.add(name)
    assert matched == set(port_by_name)


def _requests(controller, event):
    out = []
    for w in controller.watches:
        if w.kind != event.object.kind:
            continue
        if w.predicate is not None and not w.predicate(event):
            continue
        out += [(r.namespace, r.name) for r in w.mapper(event)]
    return sorted(out)


def _events(pairs, seed):
    """A seeded list of (type, port object, reference object): every
    object added, modified and (pods and nodes) deleted, an annotation
    change on every node, in a seeded order."""
    rng = random.Random(seed)
    events = []
    for port_obj, ref_obj in pairs:
        types = ["ADDED", "MODIFIED"]
        if port_obj.kind in ("Pod", "Node"):
            types.append("DELETED")
        events += [(t, port_obj, ref_obj) for t in types]
        if port_obj.kind == "Node":
            port_obj2 = tstore.Node(**{**port_obj.__dict__, "annotations": {
                **port_obj.annotations, "nos.nebuly.com/spec-partitioning-plan": "7"}})
            events.append(("MODIFIED", port_obj2, ref_obj))
    rng.shuffle(events)
    return events


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_same_events_give_the_same_requests(built, seed):
    (port, ref), pairs = built
    port_by_name = {c.name: c for c in port.controllers}
    compared = 0
    for etype, port_obj, ref_obj in _events(pairs, seed):
        tevent = tstore.WatchEvent(etype, port_obj)
        jevent = JWatchEvent(etype, ref_obj)
        for jc in ref.controllers:
            want = _requests(jc, jevent)
            for name in _port_names(jc.name):
                got = _requests(port_by_name[name], tevent)
                assert got == want, (jc.name, etype, port_obj.kind, port_obj.name)
                compared += bool(want)
    assert compared > 100


def test_a_deleted_leader_maps_to_its_workers(built):
    (port, _), pairs = built
    expander = next(c for c in port.controllers if c.name == "multinode-expander")
    leader = next(p for p, _ in pairs if getattr(p, "name", "") == "lead")
    assert _requests(expander, tstore.WatchEvent("DELETED", leader)) == [("default", "lead-w1")]
    assert _requests(expander, tstore.WatchEvent("MODIFIED", leader)) == [("default", "lead")]
