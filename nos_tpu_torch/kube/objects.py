"""The store's objects: flat dataclasses, one a kind.

Counterpart of ``nos_tpu/kube/objects.py``, kept flat on purpose (where
the reference nests ``ObjectMeta`` / ``PodSpec`` / ``PodStatus``): a node
is its name, labels, capacity, allocatable and annotations, plus the
taints and the cordon the scheduler's filters read; a pod its name,
namespace, node, phase and request ``{resource: quantity}``, plus what
the scheduler and the planner read of the reference's pod (priority,
labels, annotations, node selector, tolerations, scheduler name, uid,
creation time and nominated node; the required node affinity terms, pod
affinity and anti-affinity terms and topology spread constraints of
``:92-185``; the owner reference, hostname, subdomain and env the
multi-node expander writes) and its PodScheduled=False / Unschedulable
condition as a flag and a message; a config map its name, namespace,
labels, annotations and string data; a pod disruption budget its
selector and one of ``min_available`` / ``max_unavailable``
(``:350-363``); a headless service its selector and ports; an event what
``EventRecorder`` writes (``:326-347``). The elastic quotas are
``api/v1alpha1/elasticquota.py``'s, the ModelServing
``api/v1alpha1/modelserving.py``'s.

Every kind names itself (``kind``, a class attribute, as the
reference's objects carry it) and carries the ``resource_version`` its
store stamped on its last write (0: never stored). Every other field
defaults to "none". ``kube/serde.py`` maps each kind to the Kubernetes
JSON document the reference writes for its counterpart, and back.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | NoExecute | PreferNoSchedule


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches every effect

    def tolerates(self, taint: Taint) -> bool:
        """core/v1 semantics: an empty key with Exists tolerates every
        taint; an empty effect matches every effect."""
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        return self.operator == "Exists" or self.value == taint.value


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    capacity: Dict[str, int] = field(default_factory=dict)
    allocatable: Dict[str, int] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    namespace: str = ""  # nodes are cluster-scoped
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False  # cordoned
    resource_version: int = 0
    kind: ClassVar[str] = "Node"


@dataclass
class NodeSelectorRequirement:
    """A label requirement: In | NotIn | Exists | DoesNotExist | Gt | Lt
    (``nos_tpu/kube/objects.py:92``)."""

    key: str = ""
    operator: str = "In"
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        present = self.key in labels
        value = labels.get(self.key, "")
        if self.operator == "In":
            return present and value in self.values
        if self.operator == "NotIn":
            return not present or value not in self.values
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator in ("Gt", "Lt"):
            try:
                lhs, rhs = int(value), int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        return False


@dataclass
class NodeSelectorTerm:
    """An AND of requirements; a pod's required terms OR together."""

    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class PodAffinityTerm:
    """A required pod (anti-)affinity term: pods selected by matchLabels
    AND matchExpressions, in ``namespaces`` (empty: the owner's own), within
    a topology domain. A term with no selector selects no pod."""

    topology_key: str = ""
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    namespaces: List[str] = field(default_factory=list)

    def selects(self, pod_labels: Dict[str, str], pod_ns: str, own_ns: str) -> bool:
        if not self.match_labels and not self.match_expressions:
            return False
        if pod_ns not in (self.namespaces or [own_ns]):
            return False
        if not all(pod_labels.get(k) == v for k, v in self.match_labels.items()):
            return False
        return all(r.matches(pod_labels) for r in self.match_expressions)


@dataclass
class TopologySpreadConstraint:
    """DoNotSchedule is a filter, ScheduleAnyway a score; a constraint
    with no selector matches no pod."""

    topology_key: str = ""
    max_skew: int = 1
    when_unsatisfiable: str = "DoNotSchedule"  # DoNotSchedule | ScheduleAnyway
    match_labels: Dict[str, str] = field(default_factory=dict)

    def selects(self, labels: Dict[str, str]) -> bool:
        if not self.match_labels:
            return False
        return all(labels.get(k) == v for k, v in self.match_labels.items())


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    node: str = ""
    phase: str = PodPhase.PENDING
    request: Dict[str, int] = field(default_factory=dict)
    priority: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = ""
    # PodScheduled=False with reason Unschedulable, and the scheduler's
    # message: what the partitioner batches on
    unschedulable: bool = False
    unschedulable_message: str = ""
    # stamped by NodeStore.create: a fresh uid, and the creation time
    # (on the store's clock) unless the caller set one
    uid: str = ""
    created: Optional[float] = None
    # the node a preemption cleared for the pod (status.nominatedNodeName)
    nominated_node: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    # required node affinity: the node must match one term
    node_affinity: List[NodeSelectorTerm] = field(default_factory=list)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    owner: Optional[OwnerReference] = None
    hostname: str = ""
    subdomain: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    kind: ClassVar[str] = "Pod"

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ConfigMap:
    """Name, namespace and string data, with labels and annotations (the
    leader election's lease writes its holder and renew stamp as
    annotations)."""

    name: str
    namespace: str = ""
    data: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    kind: ClassVar[str] = "ConfigMap"


@dataclass
class PodDisruptionBudget:
    """The policy/v1 subset the preemptor reads: a matchLabels selector and
    one of min_available / max_unavailable, as absolute counts."""

    name: str
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    resource_version: int = 0
    kind: ClassVar[str] = "PodDisruptionBudget"


@dataclass
class Service:
    """A headless service: a stable DNS record per selected pod
    (``<hostname>.<name>.<namespace>.svc``)."""

    name: str
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)  # port name → number
    cluster_ip: str = "None"
    owner: Optional[OwnerReference] = None
    resource_version: int = 0
    kind: ClassVar[str] = "Service"


@dataclass
class Event:
    """A core/v1 Event (``nos_tpu/kube/objects.py:326-347``): the object it
    is about, why (a reason of ``api/v1alpha1/constants.py``), what
    happened, and the dedup bookkeeping the recorder bumps (``count``,
    ``first_timestamp`` / ``last_timestamp``, on the caller's clock: they
    default to 0, never to ``time.time``)."""

    name: str
    namespace: str = "default"
    involved_kind: str = ""
    involved_namespace: str = ""
    involved_name: str = ""
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    source_component: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    kind: ClassVar[str] = "Event"
