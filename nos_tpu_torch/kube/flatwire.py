"""The flat wire: the store's objects as plain JSON documents, field by
field, for the pool workers.

``partitioning/core/procpool.py`` ships nodes, pods and quotas to its
pool workers in this form (``pod_to_wire`` / ``pod_from_wire``,
``node_*``, the quota pairs ``eq_*`` / ``ceq_*``). A document is the
object's fields by name (those at their dataclass defaults left out:
most of a pod's are), nested terms as documents of their own, and nothing
is derived: ``x_from_wire(x_to_wire(x)) == x`` on every field, a pod's
creation time to the last bit. The Kubernetes wire (``kube/serde.py``)
cannot be used there: it writes a creation time to the whole second
(RFC 3339, as the reference), and the workers order pods tied on
priority by their creation times, which a ``SimCluster`` ticks 0.05 s
apart.

``to_wire`` / ``from_wire`` carry any kind of ``KINDS`` as a document
that names its ``kind``: the flight recorder's deltas
(``record/recorder.py``), which replay applies to a store of its own, so
a replayed decision reads every field the live one read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Type

from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.kube.objects import (
    ConfigMap,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    OwnerReference,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)


def _list_of(cls: Type) -> Callable[[Any], list]:
    return lambda docs: [_from_wire(cls, d) for d in docs]


# field → how its document becomes the field again, for the fields that
# hold terms; every other field is a JSON value as it stands
_NESTED: Dict[Type, Dict[str, Callable[[Any], Any]]] = {
    Node: {"taints": _list_of(Taint)},
    Pod: {"tolerations": _list_of(Toleration),
          "node_affinity": _list_of(NodeSelectorTerm),
          "pod_affinity": _list_of(PodAffinityTerm),
          "pod_anti_affinity": _list_of(PodAffinityTerm),
          "topology_spread_constraints": _list_of(TopologySpreadConstraint),
          "owner": lambda d: None if d is None else _from_wire(OwnerReference, d)},
    NodeSelectorTerm: {"match_expressions": _list_of(NodeSelectorRequirement)},
    PodAffinityTerm: {"match_expressions": _list_of(NodeSelectorRequirement)},
}


# class → (field, its default) of the fields that have one
_DEFAULTS: Dict[Type, tuple] = {}


def _defaults(cls: Type) -> tuple:
    found = _DEFAULTS.get(cls)
    if found is None:
        found = tuple((f.name, f.default if f.default is not dataclasses.MISSING
                       else f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else _REQUIRED) for f in dataclasses.fields(cls))
        _DEFAULTS[cls] = found
    return found


_REQUIRED = object()


def _to_wire(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        # a field at its default is left out: ``_from_wire`` gives it back
        doc = {}
        for name, default in _defaults(type(obj)):
            value = getattr(obj, name)
            if default is _REQUIRED or value != default:
                doc[name] = _to_wire(value)
        return doc
    if isinstance(obj, dict):
        return {str(k): _to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_wire(v) for v in obj]
    return obj


def _from_wire(cls: Type, doc: dict) -> Any:
    nested = _NESTED.get(cls, {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in doc:
            continue  # the dataclass's default
        value = doc[f.name]
        kwargs[f.name] = nested[f.name](value) if f.name in nested else value
    return cls(**kwargs)


def node_to_wire(node: Node) -> dict:
    return _to_wire(node)


def node_from_wire(doc: dict) -> Node:
    return _from_wire(Node, doc)


def pod_to_wire(pod: Pod) -> dict:
    return _to_wire(pod)


def pod_from_wire(doc: dict) -> Pod:
    return _from_wire(Pod, doc)


def eq_to_wire(quota: ElasticQuota) -> dict:
    return _to_wire(quota)


def eq_from_wire(doc: dict) -> ElasticQuota:
    return _from_wire(ElasticQuota, doc)


def ceq_to_wire(quota: CompositeElasticQuota) -> dict:
    return _to_wire(quota)


def ceq_from_wire(doc: dict) -> CompositeElasticQuota:
    return _from_wire(CompositeElasticQuota, doc)


# kind → class of the kinds ``to_wire`` / ``from_wire`` carry
KINDS: Dict[str, Type] = {cls.kind: cls for cls in (
    Pod, Node, ConfigMap, PodDisruptionBudget, ElasticQuota, CompositeElasticQuota)}


def to_wire(obj: Any) -> dict:
    """An object of ``KINDS`` as a document naming its ``kind``; a
    ``KeyError`` for any other kind."""
    if obj.kind not in KINDS:
        raise KeyError(obj.kind)
    doc = _to_wire(obj)
    doc["kind"] = obj.kind
    return doc


def from_wire(doc: dict) -> Any:
    """``to_wire``'s inverse."""
    fields = dict(doc)
    return _from_wire(KINDS[fields.pop("kind")], fields)
