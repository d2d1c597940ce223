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
from nos_tpu.scheduler.plugins.gang import GangScheduling as JGang
from nos_tpu.scheduler.plugins.reservation import RESERVED_FOR as REF_RESERVED_FOR
from nos_tpu.scheduler.plugins.reservation import AutoscalerGraceScoring as JGrace
from nos_tpu.scheduler.plugins.reservation import BoardReservation as JReservation
from nos_tpu.scheduler.plugins.topology import IciTopologyScoring, MultihostIciFilter
from nos_tpu.scheduler.scheduler import Scheduler as JScheduler
from nos_tpu_torch.api.v1alpha1 import elasticquota as teq
from nos_tpu_torch.kube import store as tstore
from nos_tpu_torch.scheduler import Scheduler, new_framework
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
from tests.torch_planner_cases import (
    PLUGIN_NAMES,
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
    labels: Dict[str, str] = field(default_factory=dict)


def ref_plain_node(desc: PlainNode):
    alloc = to_ref(desc.alloc)
    return jobj.Node(metadata=jobj.ObjectMeta(name=desc.name, labels=dict(desc.labels)),
                     status=jobj.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc)))


def port_plain_node(desc: PlainNode):
    return tstore.Node(desc.name, labels=dict(desc.labels), capacity=dict(desc.alloc),
                       allocatable=dict(desc.alloc))


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


def stores(nodes=(), pods=(), quotas=(), pdbs=(), clock=None):
    """(reference store, port store) holding the same objects; ``nodes``
    are PlainNodes, or (NodeDesc, advertised slices) pairs; ``clock`` is
    the port store's (``time.time`` by default)."""
    jstore = KubeStore()
    tstore_ = tstore.NodeStore() if clock is None else tstore.NodeStore(clock=clock)
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


class RefReservation(JReservation):
    """The reference's board reservation with the port's repair of F5: no
    new reservation while another pod validly holds one anywhere (the
    reference checks only the nodes big enough for the pod and not
    contested). A new annotation the reference would write is withheld
    and its answer turned to False; refreshing the pod's own stays."""

    def try_reserve(self, pod, node_infos):
        key = pod.namespaced_name
        self._blocked = any(
            self._valid_holder(info.node) not in (None, key) for info in node_infos.values()
            if REF_RESERVED_FOR in info.node.metadata.annotations)
        self._withheld = False
        reserved = super().try_reserve(pod, node_infos)
        return reserved and not self._withheld

    def _annotate(self, node_name, holder):
        node = self.store.try_get("Node", node_name)
        refresh = node is not None and node.metadata.annotations.get(REF_RESERVED_FOR) == holder
        if getattr(self, "_blocked", False) and not refresh:
            self._withheld = True
            return
        super()._annotate(node_name, holder)


class RefMultihostIciFilter(MultihostIciFilter):
    """The reference's multi-host pin with the port's repair of F6: while
    no member of the gang is bound or waiting in Permit, a member may only
    take a node in a pool whose nodes can hold every unplaced member now
    (first fit, each request against a node's available resources; the
    members not created yet count as the pod), and is not pinned when no
    pool can. The nodes are the cycle's published view, else the
    store's. A refusal carries the port's message."""

    def filter(self, state, pod, node_info):
        from nos_tpu.controllers.partitioner.multihost import MULTIHOST_TOPOLOGY_ANNOTATION
        from nos_tpu.scheduler.plugins.gang import GANG_NAME_LABEL as REF_GANG_LABEL
        from nos_tpu.scheduler.plugins.gang import gang_of as ref_gang_of
        from nos_tpu.scheduler.plugins.topology import GKE_NODEPOOL_LABEL
        from nos_tpu.util import resources as jres

        status = super().filter(state, pod, node_info)
        gang = ref_gang_of(pod)
        if (not status.success or gang is None
                or not pod.metadata.annotations.get(MULTIHOST_TOPOLOGY_ANNOTATION)):
            return status
        key, size = gang
        ns, name = key.split("/", 1)
        waiting = self.gang.waiting_members(key) if self.gang is not None else []
        members = [p for p in self.store.list("Pod", namespace=ns)
                   if p.metadata.labels.get(REF_GANG_LABEL) == name
                   and p.status.phase in ("Pending", "Running")]
        if waiting or any(p.spec.node_name for p in members):
            return status  # pinned (or unpinned) by its placed members, as before
        waiting_keys = {p.namespaced_name for p, _ in waiting}
        unplaced = [jres.compute_pod_request(p) for p in members
                    if not p.spec.node_name and p.namespaced_name not in waiting_keys
                    and p.namespaced_name != pod.namespaced_name]
        created = any(p.namespaced_name == pod.namespaced_name for p in members)
        unplaced += [jres.compute_pod_request(pod)] * max(
            1, size - len(members) + (1 if created else 0))
        infos = state.get(jfw.TOPOLOGY_NODE_INFOS_KEY)
        if infos is None:
            by_name = {n.metadata.name: jfw.NodeInfo(node=n) for n in self.store.list("Node")}
            for p in self.store.list("Pod"):
                if p.spec.node_name in by_name and p.status.phase in ("Pending", "Running"):
                    by_name[p.spec.node_name].add_pod(p)
            infos = list(by_name.values())
        frees = {}
        for info in infos:
            if info.node.spec.unschedulable:
                continue
            frees.setdefault(info.node.metadata.labels.get(GKE_NODEPOOL_LABEL, ""),
                             []).append(dict(info.available()))
        holding = set()
        for pool, rooms in frees.items():
            for want in unplaced:
                room = next((r for r in rooms
                             if all(r.get(k, 0) >= v for k, v in want.items())), None)
                if room is None:
                    break
                for k, v in want.items():
                    room[k] = room.get(k, 0) - v
            else:
                holding.add(pool)
        pool = node_info.node.metadata.labels.get(GKE_NODEPOOL_LABEL, "")
        if not holding or pool in holding:
            return status
        return jfw.Status.unschedulable(
            f"multi-node gang fits whole only in node pools {sorted(holding)}", self.name)


def ref_scheduler(jstore, gang_timeout=30.0, repair_f6=True):
    """The reference's scheduler wired as its ``new_framework`` wires it
    (CapacityScheduling, the vanilla filters, the multi-host pin, the
    board reservation, gangs in Permit, the topology, taint, spread and
    grace scores), the quotas counted at 10 GB a chip, with F5 repaired
    (``RefReservation``) and, unless ``repair_f6`` is False, F6
    (``RefMultihostIciFilter``)."""
    capacity = JCapacity(jstore, chip_memory_gb=CHIP_MEMORY_GB)
    gang = JGang(jstore, wait_timeout_seconds=gang_timeout)
    reservation = RefReservation(jstore)
    pin = (RefMultihostIciFilter if repair_f6 else MultihostIciFilter)(jstore, gang)
    framework = jfw.Framework(
        pre_filter_plugins=[capacity],
        filter_plugins=jfw.vanilla_filter_plugins() + [pin, reservation],
        post_filter_plugins=[capacity], reserve_plugins=[capacity], permit_plugins=[gang],
        score_plugins=[IciTopologyScoring(jstore), jfw.TaintTolerationScoring(),
                       jfw.PodTopologySpreadScoring(), JGrace()])
    capacity.framework = framework
    framework.reservation = reservation
    return JScheduler(jstore, framework, capacity=capacity, gang=gang)


def ref_cycle(jsched, jpod):
    """The reference's cycle through ``_decide`` and its own store writes
    (``_apply_outcome``'s binds, each releasing its reservation), without
    ``_fail_cycle``'s process-wide unschedulable metric."""
    outcome = jsched._decide(jpod)
    if outcome.decision == "bind":
        for pod, node in outcome.to_bind:
            jsched._assumed.pop(pod.namespaced_name, None)
            jsched._bind(pod, node)
            if jsched.reservation is not None:
                jsched.reservation.release_for(pod)
    elif outcome.decision == "nominate":
        jsched._set_nominated(jpod, outcome.node)
    elif outcome.decision == "fail":
        jsched._mark_unschedulable(jpod, outcome.message)
    return outcome


def ref_reconcile(jsched, name, ns):
    """The reference's ``reconcile`` of one pod, its cycle through
    ``ref_cycle``: the gang timeouts, then a cycle unless the pod is gone,
    bound, finished or waiting in Permit (None then)."""
    jsched._handle_gang_timeouts()
    pod = jsched.store.try_get("Pod", name, ns)
    key = f"{ns}/{name}"
    if pod is None:
        jsched._assumed.pop(key, None)
        if jsched.capacity is not None:
            jsched.capacity.forget_key(key)
        return None
    if pod.spec.node_name or pod.status.phase != "Pending":
        if jsched.capacity is not None:
            jsched.capacity.forget(pod)
        return None
    if key in jsched._assumed:
        return None
    return ref_cycle(jsched, pod)


class Clock:
    """One settable instant for both sides: the port store's clock, and,
    patched over the reference's gang and reservation modules' ``time``
    (``drive_ref_time``), their ``monotonic`` and ``time``."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


def drive_ref_time(monkeypatch, clock: Clock) -> None:
    """The reference's gang deadlines and reservation times read
    ``clock``; its other modules keep the real ``time``."""
    from nos_tpu.scheduler.plugins import gang as jgang_mod
    from nos_tpu.scheduler.plugins import reservation as jreservation_mod

    monkeypatch.setattr(jgang_mod, "time", clock)
    monkeypatch.setattr(jreservation_mod, "time", clock)


class Both:
    """The same cluster on both sides, one clock, one reconcile at a
    time, held equal after each."""

    def __init__(self, monkeypatch, nodes, pods=(), quotas=(), gang_timeout=30.0):
        self.clock = Clock()
        drive_ref_time(monkeypatch, self.clock)
        self.jstore, self.tstore = stores(nodes=nodes, pods=pods, quotas=quotas,
                                          clock=self.clock)
        self.jsched = ref_scheduler(self.jstore, gang_timeout=gang_timeout)
        self.tsched = Scheduler(self.tstore, new_framework(self.tstore, gang_timeout))

    def create(self, desc: PodDesc):
        if desc.created is None:
            desc.created = self.clock.t
        self.jstore.create(ref_pod(desc))
        self.tstore.create(port_pod(desc))

    def reconcile(self, name, ns="default"):
        want = ref_reconcile(self.jsched, name, ns)
        got = self.tsched.reconcile(name, ns)
        assert (got is None) == (want is None)
        if got is not None:
            assert_same_outcome(want, got)
        self.assert_same_state()
        return got

    def sched(self, desc: PodDesc):
        self.create(desc)
        return self.reconcile(desc.name, desc.ns)

    def assert_same_state(self):
        want = {p.namespaced_name: (p.spec.node_name, p.unschedulable())
                for p in self.jstore.list("Pod")}
        got = {p.namespaced_name: (p.node, p.unschedulable) for p in self.tstore.list("Pod")}
        assert got == want
        assert self.tsched.assumed() == {k: n for k, (_, n) in self.jsched._assumed.items()}
        assert self.tsched.gang.waiting_count() == self.jsched.gang.waiting_count()

    def node_of(self, name, ns="default"):
        return self.tstore.get("Pod", name, ns).node

    def set_phase(self, name, ns, phase):
        def ref(p):
            p.status.phase = phase

        self.jstore.patch_merge("Pod", name, ns, ref)
        self.tstore.patch_merge("Pod", name, ns, lambda p: setattr(p, "phase", phase))

    def delete(self, name, ns="default"):
        self.jstore.delete("Pod", name, ns)
        self.tstore.delete("Pod", name, ns)


def gang_pod(name, gang, size, request=None, ns="default", **kw):
    return PodDesc(name, dict(request or {"cpu": 1}), ns=ns,
                   labels={GANG_NAME_LABEL: gang, GANG_SIZE_LABEL: str(size)}, **kw)


def reservations(jstore, tstore_):
    """Each side's drain reservations: node → holder."""
    want = {n.metadata.name: n.metadata.annotations[REF_RESERVED_FOR]
            for n in jstore.list("Node") if REF_RESERVED_FOR in n.metadata.annotations}
    got = {n.name: n.annotations[RESERVED_FOR]
           for n in tstore_.list("Node") if RESERVED_FOR in n.annotations}
    return want, got


def cycle_both(jstore, tstore_, name, ns, jsched=None, tsched=None):
    """One cycle of pod ``ns/name`` on both sides; (reference outcome,
    port outcome)."""
    jsched = jsched or ref_scheduler(jstore)
    tsched = tsched or Scheduler(tstore_)
    want = ref_cycle(jsched, jstore.get("Pod", name, ns))
    got = tsched.schedule_one(tstore_.get("Pod", name, ns))
    return want, got


def grouped(diagnosis):
    """A diagnosis's (count, plugin, message) groups in the port's names."""
    if diagnosis is None:
        return None
    return sorted((n, PLUGIN_NAMES.get(plugin, plugin), translate_text(msg))
                  for n, plugin, msg in diagnosis.grouped())


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


def _name(pod):
    return pod.metadata.name if hasattr(pod, "metadata") else pod.name


def assert_same_outcome(want, got):
    """Decision, node, the pods bound with their nodes, victims,
    diagnosis and message."""
    assert (got.decision, got.node) == (want.decision, want.node)
    assert (sorted((_name(p), n) for p, n in got.to_bind)
            == sorted((_name(p), n) for p, n in want.to_bind))
    assert sorted(got.victims) == sorted(want.victims)
    assert grouped(got.diagnosis) == grouped(want.diagnosis)
    assert got.message == translate_text(want.message)


__all__ = ["CHIP_MEMORY_GB", "GB", "NodeDesc", "PdbDesc", "PlainNode", "PodDesc", "QuotaDesc",
           "REF_GB", "assert_same_outcome", "cycle_both", "grouped", "mig", "mps",
           "pod_view", "port_pdb", "port_pod", "port_quota", "ref_cycle", "ref_pdb",
           "ref_pod", "ref_quota", "ref_reconcile", "ref_scheduler", "reservations",
           "stores", "to_port", "to_ref", "Both", "Clock", "RefReservation", "drive_ref_time",
           "RefMultihostIciFilter",
           "gang_pod"]
