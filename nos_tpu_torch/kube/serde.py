"""The Kubernetes wire: the store's flat objects as API JSON documents.

Counterpart of ``nos_tpu/kube/serde.py`` (``:89-846``): ``to_wire`` /
``from_wire`` and a pair a kind (Node, Pod, ConfigMap, Service, Event,
PodDisruptionBudget, ElasticQuota, CompositeElasticQuota, ModelServing),
the quantity codec and ``resource_path``. ``to_wire(x)`` is the document
the reference writes for x's counterpart (``tests/torch_kube_cases.py``
builds it): a pod is one container ``main`` carrying its request and
env; its Unschedulable flag and message are its PodScheduled=False /
Unschedulable condition; its owner is its one owner reference; a
service's port ``name: number`` targets the same number.

What the flat model cannot carry (ROADMAP.md, the deliberate
differences) ``from_wire`` drops or folds:

- a uid and a creation time on any kind but a pod, a deletion time, an
  image, limits, init containers, a priority class name, owner
  references past the first, a service's other target ports;
- a pod's containers fold into one: their requests sum and their env
  merge;
- conditions other than PodScheduled=False / Unschedulable;
- absent fields take the flat defaults: a scheduler name of "" (the
  reference's ``default-scheduler``), a ModelServing's ``7g.80gb``
  (the reference's ``2x4``), a pod's creation time None.

Times go on the wire in RFC 3339 to the whole second, as the reference
writes them, so a pod created at 12.05 s comes back created at 12 s; the
pool workers' flat wire (``kube/flatwire.py``) keeps every bit.
Quantities: GPUs, slices and CPUs are plain integers; memory-like
resources (``memory``, ``*-memory``, ``storage``) are Gi ("16Gi" ↔ 16),
and an integral value comes back an ``int``.
"""
from __future__ import annotations

import calendar
import time
from typing import Any, Dict, List, Optional, Tuple

from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.v1alpha1.modelserving import (
    ModelServing,
    ModelServingSpec,
    ModelServingStatus,
)
from nos_tpu_torch.kube.objects import (
    ConfigMap,
    Event,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    OwnerReference,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    Service,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)

# kind → (api prefix, plural, namespaced)
RESOURCES: Dict[str, Tuple[str, str, bool]] = {
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Service": ("/api/v1", "services", True),
    "Event": ("/api/v1", "events", True),
    "PodDisruptionBudget": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "ElasticQuota": ("/apis/nos.nebuly.com/v1alpha1", "elasticquotas", True),
    "CompositeElasticQuota": ("/apis/nos.nebuly.com/v1alpha1", "compositeelasticquotas", True),
    "ModelServing": ("/apis/nos.nebuly.com/v1alpha1", "modelservings", True),
}

API_VERSIONS: Dict[str, str] = {
    "Pod": "v1", "Node": "v1", "ConfigMap": "v1", "Service": "v1", "Event": "v1",
    "PodDisruptionBudget": "policy/v1", "ElasticQuota": "nos.nebuly.com/v1alpha1",
    "CompositeElasticQuota": "nos.nebuly.com/v1alpha1",
    "ModelServing": "nos.nebuly.com/v1alpha1",
}

UNSCHEDULABLE = {"type": "PodScheduled", "status": "False", "reason": "Unschedulable"}
CONTAINER = "main"


def resource_path(kind: str, namespace: str = "", name: str = "") -> str:
    prefix, plural, namespaced = RESOURCES[kind]
    path = prefix
    if namespaced and namespace:
        path += f"/namespaces/{namespace}"
    path += f"/{plural}"
    if name:
        path += f"/{name}"
    return path


# ----------------------------------------------------------------- quantity

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50}
_DECIMAL = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}


def parse_quantity(value: Any, memory: bool = False) -> float:
    """A Kubernetes quantity as a float: with ``memory`` every spelling
    ("16Gi", "1G", "16384Mi", plain bytes) lands in Gi; else natural
    units ("500m" → 0.5)."""
    if isinstance(value, (int, float)):
        return float(value) / 2**30 if memory else float(value)
    s = str(value).strip()
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            v = float(s[: -len(suffix)]) * mult
            return v / 2**30 if memory else v
    for suffix, mult in _DECIMAL.items():
        if s.endswith(suffix):
            v = float(s[: -len(suffix)]) * mult
            return v / 2**30 if memory else v
    return float(s) / 2**30 if memory else float(s)


def _memory_like(name: str) -> bool:
    return "memory" in name or "storage" in name


def format_quantity(name: str, value: float) -> str:
    if _memory_like(name):
        if value == int(value):
            return f"{int(value)}Gi"
        return f"{int(value * 1024)}Mi"
    if value == int(value):
        return str(int(value))
    return f"{int(round(value * 1000))}m"


def _resources_from_wire(d: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in (d or {}).items():
        q = parse_quantity(v, memory=_memory_like(k))
        out[k] = int(q) if q == int(q) else q
    return out


def _resources_to_wire(d: Dict[str, Any]) -> Dict[str, str]:
    return {k: format_quantity(k, v) for k, v in d.items()}


# ----------------------------------------------------------------- metadata

_RFC3339 = "%Y-%m-%dT%H:%M:%SZ"


def _ts_to_wire(ts: Optional[float]) -> Optional[str]:
    if ts is None:
        return None
    return time.strftime(_RFC3339, time.gmtime(ts))


def _ts_from_wire(s: Optional[str]) -> Optional[float]:
    if not s:
        return None
    try:
        return float(calendar.timegm(time.strptime(s[:19] + "Z", _RFC3339)))
    except ValueError:
        return None


def _rv_from_wire(rv: Any) -> int:
    try:
        return int(rv)
    except (TypeError, ValueError):
        return 0


def _meta_to_wire(obj: Any, uid: str = "", created: Optional[float] = None,
                  owner: Optional[OwnerReference] = None) -> Dict[str, Any]:
    """``meta_to_wire`` of the counterpart's ObjectMeta, field for field."""
    out: Dict[str, Any] = {"name": obj.name}
    if obj.namespace:
        out["namespace"] = obj.namespace
    if uid:
        out["uid"] = uid
    labels = getattr(obj, "labels", None)
    if labels:
        out["labels"] = dict(labels)
    annotations = getattr(obj, "annotations", None)
    if annotations:
        out["annotations"] = dict(annotations)
    if obj.resource_version:
        out["resourceVersion"] = str(obj.resource_version)
    if created:
        out["creationTimestamp"] = _ts_to_wire(created)
    if owner is not None:
        out["ownerReferences"] = [{"kind": owner.kind, "name": owner.name, "uid": owner.uid,
                                   "controller": owner.controller, "apiVersion": "v1"}]
    return out


def _owner_from_wire(meta: Dict[str, Any]) -> Optional[OwnerReference]:
    refs = meta.get("ownerReferences") or []
    if not refs:
        return None
    o = refs[0]
    return OwnerReference(o.get("kind", ""), o.get("name", ""), o.get("uid", ""),
                          bool(o.get("controller", False)))


def _common(meta: Dict[str, Any]) -> Dict[str, Any]:
    return {"name": meta.get("name", ""), "namespace": meta.get("namespace", ""),
            "resource_version": _rv_from_wire(meta.get("resourceVersion"))}


# ---------------------------------------------------------------------- Pod


def _requirements_to_wire(reqs: List[NodeSelectorRequirement]) -> List[Dict[str, Any]]:
    return [{"key": r.key, "operator": r.operator, "values": list(r.values)} for r in reqs]


def _requirements_from_wire(docs) -> List[NodeSelectorRequirement]:
    return [NodeSelectorRequirement(key=e.get("key", ""), operator=e.get("operator", "In"),
                                    values=list(e.get("values") or []))
            for e in docs or []]


def _pod_terms_to_wire(terms: List[PodAffinityTerm]) -> List[Dict[str, Any]]:
    out = []
    for t in terms:
        entry: Dict[str, Any] = {"topologyKey": t.topology_key}
        selector: Dict[str, Any] = {}
        if t.match_labels:
            selector["matchLabels"] = dict(t.match_labels)
        if t.match_expressions:
            selector["matchExpressions"] = _requirements_to_wire(t.match_expressions)
        if selector:
            entry["labelSelector"] = selector
        if t.namespaces:
            entry["namespaces"] = list(t.namespaces)
        out.append(entry)
    return out


def _pod_terms_from_wire(block: Optional[Dict[str, Any]]) -> List[PodAffinityTerm]:
    out = []
    for t in (block or {}).get("requiredDuringSchedulingIgnoredDuringExecution") or []:
        selector = t.get("labelSelector") or {}
        match_labels = dict(selector.get("matchLabels") or {})
        match_expressions = _requirements_from_wire(selector.get("matchExpressions"))
        if not match_labels and not match_expressions:
            continue  # an empty selector stays nil: it matches nothing
        out.append(PodAffinityTerm(topology_key=t.get("topologyKey", ""),
                                   match_labels=match_labels,
                                   match_expressions=match_expressions,
                                   namespaces=list(t.get("namespaces") or [])))
    return out


def _affinity_to_wire(pod: Pod) -> Optional[Dict[str, Any]]:
    out: Dict[str, Any] = {}
    if pod.node_affinity:
        out["nodeAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": _requirements_to_wire(
                t.match_expressions)} for t in pod.node_affinity]}}
    if pod.pod_affinity:
        out["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution":
                              _pod_terms_to_wire(pod.pod_affinity)}
    if pod.pod_anti_affinity:
        out["podAntiAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution":
                                  _pod_terms_to_wire(pod.pod_anti_affinity)}
    return out or None


def pod_to_wire(pod: Pod) -> Dict[str, Any]:
    container: Dict[str, Any] = {"name": CONTAINER}
    if pod.request:
        container["resources"] = {"requests": _resources_to_wire(pod.request)}
    if pod.env:
        container["env"] = [{"name": k, "value": v} for k, v in sorted(pod.env.items())]
    spec: Dict[str, Any] = {"containers": [container]}
    if pod.node:
        spec["nodeName"] = pod.node
    if pod.scheduler_name:
        spec["schedulerName"] = pod.scheduler_name
    if pod.priority:
        spec["priority"] = pod.priority
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [{"key": t.key, "operator": t.operator, "value": t.value,
                                "effect": t.effect} for t in pod.tolerations]
    affinity = _affinity_to_wire(pod)
    if affinity:
        spec["affinity"] = affinity
    if pod.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {"maxSkew": c.max_skew, "topologyKey": c.topology_key,
             "whenUnsatisfiable": c.when_unsatisfiable,
             # an empty selector stays absent: the API reads {} as match-all
             **({"labelSelector": {"matchLabels": dict(c.match_labels)}}
                if c.match_labels else {})}
            for c in pod.topology_spread_constraints]
    if pod.hostname:
        spec["hostname"] = pod.hostname
    if pod.subdomain:
        spec["subdomain"] = pod.subdomain
    status: Dict[str, Any] = {"phase": pod.phase}
    if pod.unschedulable:
        status["conditions"] = [{**UNSCHEDULABLE, "message": pod.unschedulable_message}]
    if pod.nominated_node:
        status["nominatedNodeName"] = pod.nominated_node
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": _meta_to_wire(pod, pod.uid, pod.created, pod.owner),
            "spec": spec, "status": status}


def pod_from_wire(d: Dict[str, Any]) -> Pod:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    request: Dict[str, Any] = {}
    env: Dict[str, str] = {}
    for c in spec.get("containers") or []:
        for k, v in _resources_from_wire((c.get("resources") or {}).get("requests")).items():
            request[k] = request.get(k, 0) + v
        env.update({e["name"]: e.get("value", "") for e in c.get("env") or []
                    if "name" in e and "valueFrom" not in e})
    unschedulable = [c for c in status.get("conditions") or []
                     if all(c.get(k) == v for k, v in UNSCHEDULABLE.items())]
    affinity = spec.get("affinity") or {}
    node_terms = (((affinity.get("nodeAffinity") or {})
                   .get("requiredDuringSchedulingIgnoredDuringExecution") or {})
                  .get("nodeSelectorTerms") or [])
    return Pod(
        **_common(meta), labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}), uid=meta.get("uid", ""),
        created=_ts_from_wire(meta.get("creationTimestamp")), owner=_owner_from_wire(meta),
        node=spec.get("nodeName", ""), phase=status.get("phase", "Pending"),
        request=request, env=env, priority=int(spec.get("priority") or 0),
        scheduler_name=spec.get("schedulerName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        tolerations=[Toleration(key=t.get("key", ""), operator=t.get("operator", "Equal"),
                                value=t.get("value", ""), effect=t.get("effect", ""))
                     for t in spec.get("tolerations") or []],
        node_affinity=[NodeSelectorTerm(_requirements_from_wire(t.get("matchExpressions")))
                       for t in node_terms],
        pod_affinity=_pod_terms_from_wire(affinity.get("podAffinity")),
        pod_anti_affinity=_pod_terms_from_wire(affinity.get("podAntiAffinity")),
        topology_spread_constraints=[
            TopologySpreadConstraint(
                topology_key=c.get("topologyKey", ""), max_skew=int(c.get("maxSkew") or 1),
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                match_labels=dict((c.get("labelSelector") or {}).get("matchLabels") or {}))
            for c in spec.get("topologySpreadConstraints") or []],
        hostname=spec.get("hostname", ""), subdomain=spec.get("subdomain", ""),
        unschedulable=bool(unschedulable),
        unschedulable_message=unschedulable[0].get("message", "") if unschedulable else "",
        nominated_node=status.get("nominatedNodeName", ""))


# --------------------------------------------------------------------- Node


def node_to_wire(node: Node) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if node.taints:
        spec["taints"] = [{"key": t.key, "value": t.value, "effect": t.effect}
                          for t in node.taints]
    if node.unschedulable:
        spec["unschedulable"] = True
    return {"apiVersion": "v1", "kind": "Node", "metadata": _meta_to_wire(node), "spec": spec,
            "status": {"capacity": _resources_to_wire(node.capacity),
                       "allocatable": _resources_to_wire(node.allocatable)}}


def node_from_wire(d: Dict[str, Any]) -> Node:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    return Node(**_common(meta), labels=dict(meta.get("labels") or {}),
                annotations=dict(meta.get("annotations") or {}),
                capacity=_resources_from_wire(status.get("capacity")),
                allocatable=_resources_from_wire(status.get("allocatable")),
                taints=[Taint(key=t.get("key", ""), value=t.get("value", ""),
                              effect=t.get("effect", "NoSchedule"))
                        for t in spec.get("taints") or []],
                unschedulable=bool(spec.get("unschedulable", False)))


# --------------------------------------------------------- ConfigMap, Service


def configmap_to_wire(cm: ConfigMap) -> Dict[str, Any]:
    return {"apiVersion": "v1", "kind": "ConfigMap", "metadata": _meta_to_wire(cm),
            "data": dict(cm.data)}


def configmap_from_wire(d: Dict[str, Any]) -> ConfigMap:
    meta = d.get("metadata") or {}
    return ConfigMap(**_common(meta), data=dict(d.get("data") or {}),
                     labels=dict(meta.get("labels") or {}),
                     annotations=dict(meta.get("annotations") or {}))


def service_to_wire(svc: Service) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if svc.selector:
        spec["selector"] = dict(svc.selector)
    if svc.ports:
        spec["ports"] = [{"name": name, "port": port, "targetPort": port}
                         for name, port in svc.ports.items()]
    if svc.cluster_ip:
        spec["clusterIP"] = svc.cluster_ip
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": _meta_to_wire(svc, owner=svc.owner), "spec": spec}


def service_from_wire(d: Dict[str, Any]) -> Service:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    return Service(**_common(meta), selector=dict(spec.get("selector") or {}),
                   ports={p.get("name", ""): int(p.get("port") or 0)
                          for p in spec.get("ports") or []},
                   cluster_ip=str(spec.get("clusterIP") or ""), owner=_owner_from_wire(meta))


# -------------------------------------------------------------------- Event
# count and lastTimestamp live at the top level, as on core/v1 Events:
# the recorder's dedup bump is a plain merge patch


def event_to_wire(ev: Event) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "apiVersion": "v1", "kind": "Event", "metadata": _meta_to_wire(ev),
        "involvedObject": {"kind": ev.involved_kind, "namespace": ev.involved_namespace,
                           "name": ev.involved_name},
        "reason": ev.reason, "message": ev.message, "type": ev.type, "count": ev.count}
    if ev.first_timestamp:
        out["firstTimestamp"] = _ts_to_wire(ev.first_timestamp)
    if ev.last_timestamp:
        out["lastTimestamp"] = _ts_to_wire(ev.last_timestamp)
    if ev.source_component:
        out["source"] = {"component": ev.source_component}
    return out


def event_from_wire(d: Dict[str, Any]) -> Event:
    meta = d.get("metadata") or {}
    involved = d.get("involvedObject") or {}
    return Event(**_common(meta), annotations=dict(meta.get("annotations") or {}),
                 involved_kind=involved.get("kind", ""),
                 involved_namespace=involved.get("namespace", ""),
                 involved_name=involved.get("name", ""), reason=d.get("reason", ""),
                 message=d.get("message", ""), type=d.get("type", "Normal"),
                 count=int(d.get("count") or 1),
                 first_timestamp=_ts_from_wire(d.get("firstTimestamp")) or 0.0,
                 last_timestamp=_ts_from_wire(d.get("lastTimestamp")) or 0.0,
                 source_component=(d.get("source") or {}).get("component", ""))


# ---------------------------------------------------------------------- PDB


def pdb_to_wire(pdb: PodDisruptionBudget) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"selector": {"matchLabels": dict(pdb.selector)}}
    if pdb.min_available is not None:
        spec["minAvailable"] = pdb.min_available
    if pdb.max_unavailable is not None:
        spec["maxUnavailable"] = pdb.max_unavailable
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": _meta_to_wire(pdb), "spec": spec}


def pdb_from_wire(d: Dict[str, Any]) -> PodDisruptionBudget:
    spec = d.get("spec") or {}
    return PodDisruptionBudget(
        **_common(d.get("metadata") or {}),
        selector=dict((spec.get("selector") or {}).get("matchLabels") or {}),
        min_available=spec.get("minAvailable"), max_unavailable=spec.get("maxUnavailable"))


# ------------------------------------------------------------ the quotas


def eq_to_wire(eq: ElasticQuota) -> Dict[str, Any]:
    return {"apiVersion": "nos.nebuly.com/v1alpha1", "kind": "ElasticQuota",
            "metadata": _meta_to_wire(eq),
            "spec": {"min": _resources_to_wire(eq.min), "max": _resources_to_wire(eq.max)},
            "status": {"used": _resources_to_wire(eq.used)}}


def eq_from_wire(d: Dict[str, Any]) -> ElasticQuota:
    spec = d.get("spec") or {}
    return ElasticQuota(**_common(d.get("metadata") or {}),
                        min=_resources_from_wire(spec.get("min")),
                        max=_resources_from_wire(spec.get("max")),
                        used=_resources_from_wire((d.get("status") or {}).get("used")))


def ceq_to_wire(ceq: CompositeElasticQuota) -> Dict[str, Any]:
    return {"apiVersion": "nos.nebuly.com/v1alpha1", "kind": "CompositeElasticQuota",
            "metadata": _meta_to_wire(ceq),
            "spec": {"namespaces": list(ceq.namespaces), "min": _resources_to_wire(ceq.min),
                     "max": _resources_to_wire(ceq.max)},
            "status": {"used": _resources_to_wire(ceq.used)}}


def ceq_from_wire(d: Dict[str, Any]) -> CompositeElasticQuota:
    spec = d.get("spec") or {}
    return CompositeElasticQuota(**_common(d.get("metadata") or {}),
                                 namespaces=list(spec.get("namespaces") or []),
                                 min=_resources_from_wire(spec.get("min")),
                                 max=_resources_from_wire(spec.get("max")),
                                 used=_resources_from_wire((d.get("status") or {}).get("used")))


# ------------------------------------------------------------ ModelServing


def modelserving_to_wire(ms: ModelServing) -> Dict[str, Any]:
    spec, status = ms.spec, ms.status
    return {
        "apiVersion": "nos.nebuly.com/v1alpha1", "kind": "ModelServing",
        "metadata": _meta_to_wire(ms),
        "spec": {"model": spec.model, "sliceProfile": spec.slice_profile,
                 "minReplicas": spec.min_replicas, "maxReplicas": spec.max_replicas,
                 "slos": list(spec.slos),
                 "scaleToZeroIdleSeconds": spec.scale_to_zero_idle_seconds,
                 "coldStartGraceSeconds": spec.cold_start_grace_seconds,
                 "targetQueueDepth": spec.target_queue_depth,
                 "scaleDownBudgetSurplus": spec.scale_down_budget_surplus,
                 "schedulerName": spec.scheduler_name},
        "status": {"replicas": status.replicas, "readyReplicas": status.ready_replicas,
                   "desiredReplicas": status.desired_replicas,
                   "lastVerdict": status.last_verdict,
                   "lastTransitionTime": status.last_transition_t,
                   "coldStartSince": status.cold_start_since,
                   "coldStarts": status.cold_starts}}


def modelserving_from_wire(d: Dict[str, Any]) -> ModelServing:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    defaults = ModelServingSpec()
    return ModelServing(
        **_common(d.get("metadata") or {}),
        spec=ModelServingSpec(
            model=spec.get("model", ""),
            slice_profile=spec.get("sliceProfile", defaults.slice_profile),
            min_replicas=int(spec.get("minReplicas", 0)),
            max_replicas=int(spec.get("maxReplicas", 1)), slos=list(spec.get("slos") or []),
            scale_to_zero_idle_seconds=float(spec.get("scaleToZeroIdleSeconds", 300.0)),
            cold_start_grace_seconds=float(spec.get("coldStartGraceSeconds", 60.0)),
            target_queue_depth=int(spec.get("targetQueueDepth", 4)),
            scale_down_budget_surplus=float(spec.get("scaleDownBudgetSurplus", 0.5)),
            scheduler_name=spec.get("schedulerName", defaults.scheduler_name)),
        status=ModelServingStatus(
            replicas=int(status.get("replicas", 0)),
            ready_replicas=int(status.get("readyReplicas", 0)),
            desired_replicas=int(status.get("desiredReplicas", 0)),
            last_verdict=status.get("lastVerdict", ""),
            last_transition_t=float(status.get("lastTransitionTime", 0.0)),
            cold_start_since=float(status.get("coldStartSince", 0.0)),
            cold_starts=int(status.get("coldStarts", 0))))


# ----------------------------------------------------------------- dispatch

_TO_WIRE = {"Pod": pod_to_wire, "Node": node_to_wire, "ConfigMap": configmap_to_wire,
            "Service": service_to_wire, "Event": event_to_wire,
            "PodDisruptionBudget": pdb_to_wire, "ElasticQuota": eq_to_wire,
            "CompositeElasticQuota": ceq_to_wire, "ModelServing": modelserving_to_wire}

_FROM_WIRE = {"Pod": pod_from_wire, "Node": node_from_wire,
              "ConfigMap": configmap_from_wire, "Service": service_from_wire,
              "Event": event_from_wire, "PodDisruptionBudget": pdb_from_wire,
              "ElasticQuota": eq_from_wire, "CompositeElasticQuota": ceq_from_wire,
              "ModelServing": modelserving_from_wire}


def to_wire(obj: Any) -> Dict[str, Any]:
    return _TO_WIRE[obj.kind](obj)


def from_wire(d: Dict[str, Any]) -> Any:
    return _FROM_WIRE[d["kind"]](d)
