"""Shared constructors of the kube parity tests: each flat object of the port
(``nos_tpu_torch/kube/objects.py``) and its counterpart among the
reference's nested objects (``nos_tpu/kube/objects.py``), and random
objects of every kind drawn from a seed.

The counterpart of a flat object carries the same values where the
reference nests them: a pod's request and env are its one container
``main``'s, its Unschedulable flag and message its PodScheduled=False /
Unschedulable condition, its owner its one owner reference, its
creation time its ``creation_timestamp`` (None: 0); a service's port
``name: number`` targets the same number. Where the flat model keeps no
uid or creation time (every kind but the pod), the counterpart has none.
"""
import random

from nos_tpu.api.v1alpha1 import elasticquota as jeq
from nos_tpu.api.v1alpha1 import modelserving as jms
from nos_tpu.kube import objects as jobj
from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.v1alpha1.modelserving import (
    ModelServing,
    ModelServingSpec,
    ModelServingStatus,
)
from nos_tpu_torch.kube import objects as tobj

# the resources a drawn object asks for, holds or bounds
RESOURCES = ("nvidia.com/gpu", "nvidia.com/mig-1g.10gb", "nvidia.com/mig-3g.40gb",
             "nvidia.com/gpu-20gb", "cpu", "memory", "nos.nebuly.com/gpu-memory")
# whole seconds after 2026-01-01: the wire's timestamps are whole seconds
T0 = 1_767_225_600.0


def _meta(obj, uid="", created=None, owner=None, labels=True, annotations=True):
    return jobj.ObjectMeta(
        name=obj.name, namespace=obj.namespace, uid=uid,
        labels=dict(obj.labels) if labels else {},
        annotations=dict(obj.annotations) if annotations else {},
        creation_timestamp=created or 0.0, resource_version=obj.resource_version,
        owner_references=[] if owner is None else [
            jobj.OwnerReference(owner.kind, owner.name, owner.uid, owner.controller)])


def _requirements(reqs):
    return [jobj.NodeSelectorRequirement(r.key, r.operator, list(r.values)) for r in reqs]


def _pod_terms(terms):
    return [jobj.PodAffinityTerm(topology_key=t.topology_key, match_labels=dict(t.match_labels),
                                 match_expressions=_requirements(t.match_expressions),
                                 namespaces=list(t.namespaces)) for t in terms]


def to_ref(obj):
    """The reference's counterpart of a flat object."""
    kind = obj.kind
    if kind == "Pod":
        return jobj.Pod(
            metadata=_meta(obj, obj.uid, obj.created, obj.owner),
            spec=jobj.PodSpec(
                containers=[jobj.Container(name="main", requests=dict(obj.request),
                                           env=dict(obj.env))],
                node_name=obj.node, scheduler_name=obj.scheduler_name, priority=obj.priority,
                tolerations=[jobj.Toleration(t.key, t.operator, t.value, t.effect)
                             for t in obj.tolerations],
                node_selector=dict(obj.node_selector),
                affinity=jobj.NodeAffinity([jobj.NodeSelectorTerm(_requirements(
                    t.match_expressions)) for t in obj.node_affinity])
                if obj.node_affinity else None,
                pod_affinity=_pod_terms(obj.pod_affinity),
                pod_anti_affinity=_pod_terms(obj.pod_anti_affinity),
                topology_spread_constraints=[jobj.TopologySpreadConstraint(
                    c.topology_key, c.max_skew, c.when_unsatisfiable, dict(c.match_labels))
                    for c in obj.topology_spread_constraints],
                hostname=obj.hostname, subdomain=obj.subdomain),
            status=jobj.PodStatus(
                phase=obj.phase, nominated_node_name=obj.nominated_node,
                conditions=[jobj.PodCondition("PodScheduled", "False", "Unschedulable",
                                              obj.unschedulable_message)]
                if obj.unschedulable else []))
    if kind == "Node":
        return jobj.Node(metadata=_meta(obj),
                         spec=jobj.NodeSpec([jobj.Taint(t.key, t.value, t.effect)
                                             for t in obj.taints], obj.unschedulable),
                         status=jobj.NodeStatus(dict(obj.capacity), dict(obj.allocatable)))
    if kind == "ConfigMap":
        return jobj.ConfigMap(metadata=_meta(obj), data=dict(obj.data))
    if kind == "Service":
        return jobj.Service(
            metadata=_meta(obj, owner=obj.owner, labels=False, annotations=False),
            spec=jobj.ServiceSpec(dict(obj.selector), [jobj.ServicePort(n, p, p)
                                                       for n, p in obj.ports.items()],
                                  obj.cluster_ip))
    if kind == "Event":
        return jobj.Event(
            metadata=_meta(obj, labels=False), involved_kind=obj.involved_kind,
            involved_namespace=obj.involved_namespace, involved_name=obj.involved_name,
            reason=obj.reason, message=obj.message, type=obj.type, count=obj.count,
            first_timestamp=obj.first_timestamp, last_timestamp=obj.last_timestamp,
            source_component=obj.source_component)
    if kind == "PodDisruptionBudget":
        return jobj.PodDisruptionBudget(
            metadata=_meta(obj, labels=False, annotations=False),
            spec=jobj.PodDisruptionBudgetSpec(dict(obj.selector), obj.min_available,
                                              obj.max_unavailable))
    if kind == "ElasticQuota":
        return jeq.ElasticQuota(metadata=_meta(obj, labels=False, annotations=False),
                                spec=jeq.ElasticQuotaSpec(dict(obj.min), dict(obj.max)),
                                status=jeq.ElasticQuotaStatus(dict(obj.used)))
    if kind == "CompositeElasticQuota":
        return jeq.CompositeElasticQuota(
            metadata=_meta(obj, labels=False, annotations=False),
            spec=jeq.CompositeElasticQuotaSpec(list(obj.namespaces), dict(obj.min),
                                               dict(obj.max)),
            status=jeq.ElasticQuotaStatus(dict(obj.used)))
    if kind == "ModelServing":
        s, st = obj.spec, obj.status
        return jms.ModelServing(
            metadata=_meta(obj, labels=False, annotations=False),
            spec=jms.ModelServingSpec(s.model, s.slice_profile, s.min_replicas, s.max_replicas,
                                      list(s.slos), s.scale_to_zero_idle_seconds,
                                      s.cold_start_grace_seconds, s.target_queue_depth,
                                      s.scale_down_budget_surplus, s.scheduler_name),
            status=jms.ModelServingStatus(st.replicas, st.ready_replicas, st.desired_replicas,
                                          st.last_verdict, st.last_transition_t,
                                          st.cold_start_since, st.cold_starts))
    raise TypeError(kind)


def ref_view(obj):
    """(kind, namespace, name, resource version) of either side's object."""
    meta = getattr(obj, "metadata", obj)
    return (obj.kind, meta.namespace, meta.name, meta.resource_version)


# ------------------------------------------------------------ random draws


def _word(rng, prefix=""):
    return prefix + rng.choice(["a", "b", "c", "web", "ml", "x1"])


def _strmap(rng, n=3):
    return {f"k{rng.randrange(5)}.io/{_word(rng)}": _word(rng) for _ in range(rng.randrange(n))}


def _resources(rng, memory_gb=True):
    out = {}
    for name in rng.sample(RESOURCES, rng.randrange(4)):
        out[name] = rng.choice([1, 2, 8, 80, 2048]) if memory_gb or "memory" not in name else 1
    return out


def _reqs(rng):
    ops = ["In", "NotIn", "Exists", "DoesNotExist", "Gt"]
    return [tobj.NodeSelectorRequirement(_word(rng, "key-"), rng.choice(ops),
                                         [str(rng.randrange(9)) for _ in range(rng.randrange(3))])
            for _ in range(rng.randrange(1, 3))]


def _owner(rng):
    if rng.random() < 0.5:
        return None
    return tobj.OwnerReference(rng.choice(["Pod", "Job"]), _word(rng, "o-"),
                               f"uid-{rng.randrange(99)}", rng.random() < 0.5)


def random_pod(rng, name=None):
    unschedulable = rng.random() < 0.4
    return tobj.Pod(
        name or _word(rng, "p-") + str(rng.randrange(1000)), rng.choice(["default", "ml"]),
        node=rng.choice(["", "n0", "n1"]), phase=rng.choice(["Pending", "Running", "Failed"]),
        request=_resources(rng), priority=rng.choice([0, 0, 5, -3]), labels=_strmap(rng),
        node_selector=_strmap(rng),
        tolerations=[tobj.Toleration(_word(rng), rng.choice(["Equal", "Exists"]), _word(rng),
                                     rng.choice(["", "NoSchedule"]))
                     for _ in range(rng.randrange(3))],
        scheduler_name=rng.choice(["", "nos-scheduler"]), unschedulable=unschedulable,
        unschedulable_message="0/3 nodes are available" if unschedulable else "",
        uid=rng.choice(["", f"uid-{rng.randrange(99)}"]),
        created=rng.choice([None, T0 + rng.randrange(10_000)]),
        nominated_node=rng.choice(["", "n1"]), annotations=_strmap(rng),
        node_affinity=[tobj.NodeSelectorTerm(_reqs(rng)) for _ in range(rng.randrange(3))],
        pod_affinity=[tobj.PodAffinityTerm(_word(rng, "topo-"), {"app": _word(rng)}, _reqs(rng),
                                           rng.choice([[], ["ml"]]))
                      for _ in range(rng.randrange(2))],
        pod_anti_affinity=[tobj.PodAffinityTerm(_word(rng, "topo-"), {"app": _word(rng)})
                           for _ in range(rng.randrange(2))],
        topology_spread_constraints=[tobj.TopologySpreadConstraint(
            _word(rng, "zone-"), rng.randrange(1, 3), rng.choice(["DoNotSchedule",
                                                                   "ScheduleAnyway"]),
            rng.choice([{}, {"app": _word(rng)}])) for _ in range(rng.randrange(2))],
        owner=_owner(rng), hostname=rng.choice(["", "h0"]), subdomain=rng.choice(["", "svc"]),
        env=_strmap(rng), resource_version=rng.randrange(50))


def random_object(rng, kind):
    rv = rng.randrange(50)
    name = _word(rng, "o-") + str(rng.randrange(1000))
    ns = rng.choice(["default", "ml"])
    if kind == "Pod":
        return random_pod(rng, name)
    if kind == "Node":
        return tobj.Node(name, _strmap(rng), _resources(rng), _resources(rng), _strmap(rng),
                         taints=[tobj.Taint(_word(rng), _word(rng), rng.choice(
                             ["NoSchedule", "NoExecute"])) for _ in range(rng.randrange(3))],
                         unschedulable=rng.random() < 0.3, resource_version=rv)
    if kind == "ConfigMap":
        return tobj.ConfigMap(name, ns, {"config.yaml": "a: 1"} if rng.random() < 0.7 else {},
                              _strmap(rng), _strmap(rng), resource_version=rv)
    if kind == "Service":
        return tobj.Service(name, ns, _strmap(rng), {"coord": 8476} if rng.random() < 0.7
                            else {}, rng.choice(["None", "10.0.0.1", ""]), _owner(rng),
                            resource_version=rv)
    if kind == "Event":
        return tobj.Event(name, ns, rng.choice(["Pod", "Node"]), ns, _word(rng),
                          rng.choice(["Scheduled", "Preempted"]), "msg " + _word(rng),
                          rng.choice(["Normal", "Warning"]), rng.randrange(1, 9),
                          T0 + rng.randrange(100), T0 + 100 + rng.randrange(100),
                          rng.choice(["", "nos-scheduler"]), _strmap(rng), resource_version=rv)
    if kind == "PodDisruptionBudget":
        return tobj.PodDisruptionBudget(name, ns, _strmap(rng), rng.choice([None, 1, 2]),
                                        rng.choice([None, 1]), resource_version=rv)
    if kind == "ElasticQuota":
        return ElasticQuota(name, ns, _resources(rng), _resources(rng), _resources(rng),
                            resource_version=rv)
    if kind == "CompositeElasticQuota":
        return CompositeElasticQuota(name, ns, ["a", "b"][: rng.randrange(3)], _resources(rng),
                                     _resources(rng), _resources(rng), resource_version=rv)
    if kind == "ModelServing":
        return ModelServing(name, ns, ModelServingSpec(
            model=_word(rng), slice_profile=rng.choice(["3g.40gb", "7g.80gb"]),
            min_replicas=rng.randrange(2), max_replicas=rng.randrange(2, 5),
            slos=rng.choice([[], ["ttft_p95<0.5s"]]), scale_to_zero_idle_seconds=30.0,
            cold_start_grace_seconds=rng.choice([0.0, 40.0]), target_queue_depth=4,
            scale_down_budget_surplus=0.5),
            ModelServingStatus(rng.randrange(3), rng.randrange(3), rng.randrange(3),
                               rng.choice(["", "hold"]), 12.5, 0.0, rng.randrange(3)),
            resource_version=rv)
    raise TypeError(kind)


KINDS = ("Pod", "Node", "ConfigMap", "Service", "Event", "PodDisruptionBudget",
         "ElasticQuota", "CompositeElasticQuota", "ModelServing")


def draw(seed, kind):
    return random_object(random.Random(f"{seed}-{kind}"), kind)
