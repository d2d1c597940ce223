"""Translated cases for the quota tests: quotas, PodDisruptionBudgets,
plain nodes and stores, built on both sides from one description.

Descriptions are written in the port's names. The reference runs with
``chip_memory_gb=10``, so its ``nos.nebuly.com/tpu-memory`` equals the
port's ``nos.nebuly.com/gpu-memory`` GB for GB under
tests/torch_planner_cases.py's mapping (a 1x1 / 1x2 / 2x2 / 2x4 slice is
10 / 20 / 40 / 80 GB, as 1g.10gb / 2g.20gb / 4g.40gb / 7g.80gb are; an
MPS slice counts its GB on both sides). The reference's
``nos.nebuly.com/tpu-chips`` has no counterpart: it is dropped where the
reference reports it. Plain-GPU requests do not translate (a plain chip
is not a plain GPU) and are tested on the port alone.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu.api.v1alpha1 import constants
from nos_tpu.api.v1alpha1 import elasticquota as jeq
from nos_tpu.kube import objects as jobj
from nos_tpu.kube.store import KubeStore
from nos_tpu.scheduler import framework as jfw
from nos_tpu.scheduler.plugins.capacity import CapacityScheduling as JCapacity
from nos_tpu.scheduler.scheduler import Scheduler as JScheduler
from nos_tpu_torch.api.v1alpha1 import elasticquota as teq
from nos_tpu_torch.kube import store as tstore
from nos_tpu_torch.scheduler import Scheduler
from tests.torch_planner_cases import (
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
    to_port_resource,
    to_ref_resource,
    translate_text,
)

CHIP_MEMORY_GB = 10
GB = teq.RESOURCE_GPU_MEMORY
REF_GB = constants.RESOURCE_TPU_MEMORY
assert to_ref_resource(GB) == REF_GB


def mig(profile):
    return f"nvidia.com/mig-{profile}"


def mps(profile):
    return f"nvidia.com/gpu-{profile}"


def to_ref(resources: Dict[str, int]) -> Dict[str, int]:
    return {to_ref_resource(k): v for k, v in resources.items()}


def to_port(resources: Dict[str, int]) -> Dict[str, int]:
    """A reference resource map in the port's names, tpu-chips dropped."""
    return {to_port_resource(k): v for k, v in resources.items()
            if k != constants.RESOURCE_TPU_CHIPS}


@dataclass
class QuotaDesc:
    ns: str
    min: Dict[str, int] = field(default_factory=dict)
    max: Dict[str, int] = field(default_factory=dict)
    name: str = "quota"
    namespaces: Optional[List[str]] = None  # set: a CompositeElasticQuota


def ref_quota(desc: QuotaDesc):
    meta = jobj.ObjectMeta(name=desc.name, namespace=desc.ns)
    if desc.namespaces is not None:
        return jeq.CompositeElasticQuota(
            metadata=meta, spec=jeq.CompositeElasticQuotaSpec(
                namespaces=list(desc.namespaces), min=to_ref(desc.min), max=to_ref(desc.max)))
    return jeq.ElasticQuota(metadata=meta, spec=jeq.ElasticQuotaSpec(min=to_ref(desc.min),
                                                                     max=to_ref(desc.max)))


def port_quota(desc: QuotaDesc):
    if desc.namespaces is not None:
        return teq.CompositeElasticQuota(desc.name, desc.ns, list(desc.namespaces),
                                         dict(desc.min), dict(desc.max))
    return teq.ElasticQuota(desc.name, desc.ns, dict(desc.min), dict(desc.max))


@dataclass
class PdbDesc:
    name: str
    ns: str
    selector: Dict[str, str]
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None


def ref_pdb(desc: PdbDesc):
    return jobj.PodDisruptionBudget(
        metadata=jobj.ObjectMeta(name=desc.name, namespace=desc.ns),
        spec=jobj.PodDisruptionBudgetSpec(selector=dict(desc.selector),
                                          min_available=desc.min_available,
                                          max_unavailable=desc.max_unavailable))


def port_pdb(desc: PdbDesc):
    return tstore.PodDisruptionBudget(desc.name, desc.ns, dict(desc.selector),
                                      desc.min_available, desc.max_unavailable)


@dataclass
class PlainNode:
    """A node with no GPU labels, allocatable as given (the reference's
    ``tests.factory.build_node``)."""

    name: str
    alloc: Dict[str, int] = field(default_factory=dict)


def ref_plain_node(desc: PlainNode):
    alloc = to_ref(desc.alloc)
    return jobj.Node(metadata=jobj.ObjectMeta(name=desc.name),
                     status=jobj.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc)))


def port_plain_node(desc: PlainNode):
    return tstore.Node(desc.name, capacity=dict(desc.alloc), allocatable=dict(desc.alloc))


def ref_any_node(desc, advertised=None):
    if isinstance(desc, PlainNode):
        return ref_plain_node(desc)
    node = ref_node(desc)
    node.status.allocatable.update(to_ref(advertised or {}))
    return node


def port_any_node(desc, advertised=None):
    if isinstance(desc, PlainNode):
        return port_plain_node(desc)
    node = port_node(desc)
    node.allocatable.update(advertised or {})
    return node


def stores(nodes=(), pods=(), quotas=(), pdbs=()):
    """(reference store, port store) holding the same objects; ``nodes``
    are PlainNodes, or (NodeDesc, advertised slices) pairs."""
    jstore, tstore_ = KubeStore(), tstore.NodeStore()
    for entry in nodes:
        desc, advertised = entry if isinstance(entry, tuple) else (entry, None)
        jstore.create(ref_any_node(desc, advertised))
        tstore_.create(port_any_node(desc, advertised))
    for q in quotas:
        jstore.create(ref_quota(q))
        tstore_.create(port_quota(q))
    for p in pods:
        jstore.create(ref_pod(p))
        tstore_.create(port_pod(p))
    for b in pdbs:
        jstore.create(ref_pdb(b))
        tstore_.create(port_pdb(b))
    return jstore, tstore_


def ref_scheduler(jstore):
    """The reference's scheduler with CapacityScheduling and the vanilla
    filters (its gang, reservation and topology plugins left out: they
    wait for the gang slice), the quotas counted at 10 GB a chip."""
    capacity = JCapacity(jstore, chip_memory_gb=CHIP_MEMORY_GB)
    framework = jfw.Framework(pre_filter_plugins=[capacity],
                              filter_plugins=jfw.vanilla_filter_plugins(),
                              post_filter_plugins=[capacity], reserve_plugins=[capacity],
                              score_plugins=[jfw.TaintTolerationScoring()])
    capacity.framework = framework
    return JScheduler(jstore, framework, capacity=capacity)


def ref_cycle(jsched, jpod):
    """The reference's cycle through ``_decide`` and its own store writes,
    without ``_fail_cycle``'s process-wide unschedulable metric."""
    outcome = jsched._decide(jpod)
    if outcome.decision == "bind":
        jsched._bind(jpod, outcome.node)
    elif outcome.decision == "nominate":
        jsched._set_nominated(jpod, outcome.node)
    else:
        jsched._mark_unschedulable(jpod, outcome.message)
    return outcome


def cycle_both(jstore, tstore_, name, ns, jsched=None, tsched=None):
    """One cycle of pod ``ns/name`` on both sides; (reference outcome,
    port outcome)."""
    jsched = jsched or ref_scheduler(jstore)
    tsched = tsched or Scheduler(tstore_)
    want = ref_cycle(jsched, jstore.get("Pod", name, ns))
    got = tsched.schedule_one(tstore_.get("Pod", name, ns))
    return want, got


def grouped(diagnosis):
    if diagnosis is None:
        return None
    return [(n, plugin, translate_text(msg)) for n, plugin, msg in diagnosis.grouped()]


def pod_view(jstore, tstore_):
    """Every pod on both sides: (node, nominated node, capacity label),
    by namespaced name."""
    label = teq.CAPACITY_LABEL
    want = {p.namespaced_name: (p.spec.node_name, p.status.nominated_node_name,
                                p.metadata.labels.get(label))
            for p in jstore.list("Pod")}
    got = {p.namespaced_name: (p.node, p.nominated_node, p.labels.get(label))
           for p in tstore_.list("Pod")}
    return want, got


def assert_same_outcome(want, got):
    assert (got.decision, got.node) == (want.decision, want.node)
    assert sorted(got.victims) == sorted(want.victims)
    assert grouped(got.diagnosis) == grouped(want.diagnosis)
    assert got.message == translate_text(want.message)


__all__ = ["CHIP_MEMORY_GB", "GB", "NodeDesc", "PdbDesc", "PlainNode", "PodDesc", "QuotaDesc",
           "REF_GB", "assert_same_outcome", "cycle_both", "grouped", "mig", "mps",
           "pod_view", "port_pdb", "port_pod", "port_quota", "ref_cycle", "ref_pdb",
           "ref_pod", "ref_quota", "ref_scheduler", "stores", "to_port", "to_ref"]
