"""The scheduler framework: extension points, the cycle's scratch state,
the per-node rejection ledger and the vanilla predicates.

Counterpart of ``nos_tpu/scheduler/framework.py`` (the k8s scheduler
framework as the reference uses it): ``StatusCode`` / ``Status`` with
Permit's ``WAIT`` (``:20-53``), ``CycleState`` (``:54``), ``Diagnosis``
(``:59``), ``NodeInfo`` (``:106``), ``Framework`` (``:216``) with its
PreFilter, Filter, PostFilter, Score, Reserve, Unreserve and Permit
runners, the ``verdict_cacheable`` marks (``:173``), the filters
``NodeResourcesFit`` (``:323``), ``NodeSelectorFit`` (``:369``),
``NodeAffinityFit`` (``:388``), ``TaintTolerationFit`` (``:404``),
``NodeUnschedulableFit`` (``:424``), ``PodTopologySpreadFit``
(``:446-535``) and ``InterPodAffinityFit`` (``:537-712``), the scores
``TaintTolerationScoring`` (``:714``) and ``PodTopologySpreadScoring``
(``:731``), and ``vanilla_filter_plugins`` (``:779``).

The spread and inter-pod affinity filters read the whole cluster: the
cycle's driver (the scheduler, the preemptor's victim trials, the
planner's simulation) publishes every ``NodeInfo`` under
``TOPOLOGY_NODE_INFOS_KEY``, and the filter substitutes the ``NodeInfo``
it is handed for the candidate's published one, so a trial view (victims
removed) wins over the published counts. A pod's request is one map,
and a plain ``nvidia.com/gpu`` request is never normalized into a slice.
Per-plugin spans are left out: the cycle's own span carries the story.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

from nos_tpu_torch.kube.store import Node, Pod, Taint
from nos_tpu_torch.util import resources as res


class StatusCode:
    SUCCESS = "Success"
    UNSCHEDULABLE = "Unschedulable"
    WAIT = "Wait"  # Permit: hold the pod (gang scheduling)
    ERROR = "Error"


@dataclass
class Status:
    code: str = StatusCode.SUCCESS
    message: str = ""
    plugin: str = ""

    @property
    def success(self) -> bool:
        return self.code == StatusCode.SUCCESS

    @staticmethod
    def ok() -> "Status":
        return Status()

    @staticmethod
    def unschedulable(message: str, plugin: str = "") -> "Status":
        return Status(StatusCode.UNSCHEDULABLE, message, plugin)

    @staticmethod
    def wait(message: str, plugin: str = "") -> "Status":
        return Status(StatusCode.WAIT, message, plugin)

    @staticmethod
    def error(message: str, plugin: str = "") -> "Status":
        return Status(StatusCode.ERROR, message, plugin)


class CycleState(dict):
    """Per-cycle scratch space shared between extension points."""


@dataclass
class Diagnosis:
    """Per-node, per-plugin rejections of one failed cycle: the source of
    the Unschedulable condition's message."""

    pod: str = ""  # namespaced name
    num_nodes: int = 0
    node_statuses: Dict[str, Status] = field(default_factory=dict)

    def grouped(self) -> List[tuple]:
        """(count, plugin, message) per distinct rejection, most frequent
        first, ties broken lexically."""
        counts: Dict[tuple, int] = {}
        for status in self.node_statuses.values():
            key = (status.plugin, status.message)
            counts[key] = counts.get(key, 0) + 1
        return sorted(((n, plugin, msg) for (plugin, msg), n in counts.items()),
                      key=lambda t: (-t[0], t[1], t[2]))

    def aggregate_message(self) -> str:
        """``0/N nodes are available: X <reason>, Y <reason>.``"""
        groups = self.grouped()
        if not groups:
            return f"0/{self.num_nodes} nodes are available: no nodes."
        parts = ", ".join(f"{n} {msg}" for n, _, msg in groups)
        return f"0/{self.num_nodes} nodes are available: {parts}."

    def to_dict(self, timestamp: float = 0.0) -> Dict:
        """The ``/debug/explain`` document (the reference's, without its
        trace id)."""
        return {"pod": self.pod, "message": self.aggregate_message(),
                "nodes": {name: {"plugin": s.plugin, "message": s.message}
                          for name, s in sorted(self.node_statuses.items())},
                "timestamp": timestamp}


@dataclass
class NodeInfo:
    """A node and the pods placed on it."""

    node: Node
    pods: List[Pod] = field(default_factory=list)
    # (pods list, its length, their summed request): the filters and
    # scores ask once per plugin; add_pod / remove_pod change the key
    _requested: Optional[tuple] = field(default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.node.name

    def requested(self) -> res.ResourceList:
        memo = self._requested
        if memo is None or memo[0] is not self.pods or memo[1] != len(self.pods):
            total: res.ResourceList = {}
            for pod in self.pods:
                total = res.sum_resources(total, res.compute_pod_request(pod))
            memo = self._requested = (self.pods, len(self.pods), total)
        return dict(memo[2])

    def available(self) -> res.ResourceList:
        return res.subtract_resources(self.node.allocatable, self.requested())

    def add_pod(self, pod: Pod) -> None:
        self.pods.append(pod)

    def remove_pod(self, pod: Pod) -> None:
        self.pods = [p for p in self.pods
                     if not (p.namespace == pod.namespace and p.name == pod.name)]


# ---------------------------------------------------------------- plugins


class PreFilterPlugin(Protocol):
    name: str

    def pre_filter(self, state: CycleState, pod: Pod) -> Status: ...


class FilterPlugin(Protocol):
    name: str

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status: ...


class PostFilterPlugin(Protocol):
    name: str

    def post_filter(self, state: CycleState, pod: Pod,
                    filtered_nodes: Dict[str, Status]) -> Optional[str]:
        """Try to make the pod schedulable (preemption); the nominated
        node's name, or None."""
        ...


class ReservePlugin(Protocol):
    name: str

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status: ...

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None: ...


class ScorePlugin(Protocol):
    name: str

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        """0-100; higher is better."""
        ...


class PermitPlugin(Protocol):
    name: str

    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Status: ...


def is_verdict_cacheable(plugin) -> bool:
    """The verdict-cache opt-in (``partitioning/core/verdict_cache.py``): a
    PreFilter or Filter plugin with ``verdict_cacheable = True`` promises
    its verdict is a pure function of the signed pod fields and the
    candidate node's own state. Unmarked plugins run on every trial."""
    return bool(getattr(plugin, "verdict_cacheable", False))


class Framework:
    """Plugin registry and per-extension-point runners."""

    def __init__(self, pre_filter_plugins: Sequence[PreFilterPlugin] = (),
                 filter_plugins: Sequence[FilterPlugin] = (),
                 reserve_plugins: Sequence[ReservePlugin] = (),
                 score_plugins: Sequence[ScorePlugin] = (),
                 post_filter_plugins: Sequence[PostFilterPlugin] = (),
                 permit_plugins: Sequence[PermitPlugin] = ()) -> None:
        self.pre_filter_plugins = list(pre_filter_plugins)
        self.filter_plugins = list(filter_plugins)
        self.post_filter_plugins = list(post_filter_plugins)
        self.reserve_plugins = list(reserve_plugins)
        self.score_plugins = list(score_plugins)
        self.permit_plugins = list(permit_plugins)

    def run_pre_filter_plugins(self, state: CycleState, pod: Pod,
                               plugins: Optional[Sequence[PreFilterPlugin]] = None) -> Status:
        """``plugins`` narrows the run to a subset (the planner's verdict
        cache splits the chain); None runs the registered chain."""
        for p in self.pre_filter_plugins if plugins is None else plugins:
            status = p.pre_filter(state, pod)
            if not status.success:
                status.plugin = status.plugin or p.name
                return status
        return Status.ok()

    def run_filter_plugins(self, state: CycleState, pod: Pod, node_info: NodeInfo,
                           plugins: Optional[Sequence[FilterPlugin]] = None) -> Status:
        for p in self.filter_plugins if plugins is None else plugins:
            status = p.filter(state, pod, node_info)
            if not status.success:
                status.plugin = status.plugin or p.name
                return status
        return Status.ok()

    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                filtered_nodes: Dict[str, Status]) -> Optional[str]:
        """The first node a PostFilter plugin nominates, or None."""
        for p in self.post_filter_plugins:
            nominated = p.post_filter(state, pod, filtered_nodes)
            if nominated:
                return nominated
        return None

    def run_reserve_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for i, p in enumerate(self.reserve_plugins):
            status = p.reserve(state, pod, node_name)
            if not status.success:
                for done in self.reserve_plugins[:i]:
                    done.unreserve(state, pod, node_name)
                status.plugin = status.plugin or p.name
                return status
        return Status.ok()

    def run_unreserve_plugins(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self.reserve_plugins:
            p.unreserve(state, pod, node_name)

    def run_score_plugins(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        return sum(p.score(state, pod, node_info) for p in self.score_plugins)

    def run_permit_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """The first non-success status (a WAIT holds the pod), else ok."""
        for p in self.permit_plugins:
            status = p.permit(state, pod, node_name)
            if not status.success:
                status.plugin = status.plugin or p.name
                return status
        return Status.ok()


class NodeResourcesFit:
    """Every requested resource within what the node has left: the part of
    the vanilla scheduler that sees the partitioned scalar resources."""

    name = "NodeResourcesFit"
    verdict_cacheable = True  # signed request vs allocatable and placed pods

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        available = node_info.available()
        for resource, qty in res.compute_pod_request(pod).items():
            if qty > available.get(resource, 0):
                return Status.unschedulable(
                    f"insufficient {resource}: requested {qty}, available "
                    f"{available.get(resource, 0)}", self.name)
        return Status.ok()


class NodeSelectorFit:
    """The pod's node (when named) and node selector against the node."""

    name = "NodeSelector"
    verdict_cacheable = True  # signed node / node selector vs node labels

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if pod.node and pod.node != node_info.name:
            return Status.unschedulable("pod bound to a different node", self.name)
        labels = node_info.node.labels
        for key, value in pod.node_selector.items():
            if labels.get(key) != value:
                return Status.unschedulable(f"node selector {key}={value} not satisfied",
                                            self.name)
        return Status.ok()


class NodeAffinityFit:
    """The node's labels match one of the pod's required node-affinity
    terms (or the pod has none)."""

    name = "NodeAffinity"
    verdict_cacheable = True  # signed required terms vs node labels

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        terms = pod.node_affinity
        if not terms or any(t.matches(node_info.node.labels) for t in terms):
            return Status.ok()
        return Status.unschedulable("required node affinity not satisfied", self.name)


class TaintTolerationFit:
    """Every NoSchedule / NoExecute taint tolerated (PreferNoSchedule only
    scores)."""

    name = "TaintToleration"
    verdict_cacheable = True  # signed tolerations vs node taints

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        for taint in node_info.node.taints:
            if taint.effect not in ("NoSchedule", "NoExecute"):
                continue
            if not any(t.tolerates(taint) for t in pod.tolerations):
                return Status.unschedulable(
                    f"untolerated taint {taint.key}={taint.value}:{taint.effect}", self.name)
        return Status.ok()


class NodeUnschedulableFit:
    """A cordoned node admits nothing without a toleration of the cordon."""

    name = "NodeUnschedulable"
    verdict_cacheable = True  # node cordon vs signed tolerations

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if not node_info.node.unschedulable:
            return Status.ok()
        cordon = Taint(key="node.kubernetes.io/unschedulable", effect="NoSchedule")
        if any(t.tolerates(cordon) for t in pod.tolerations):
            return Status.ok()
        return Status.unschedulable("node is cordoned (unschedulable)", self.name)


# the CycleState key under which a cycle's driver publishes every NodeInfo
# of the cluster view it runs against
TOPOLOGY_NODE_INFOS_KEY = "topology_node_infos"


def _hard_spread(pod: Pod) -> list:
    return [c for c in pod.topology_spread_constraints
            if c.when_unsatisfiable == "DoNotSchedule"]


class PodTopologySpreadFit:
    """DoNotSchedule spread constraints: placing the pod must not take its
    domain more than ``max_skew`` matching pods (the pod counted when it
    matches) above the emptiest domain seen. Domains are the published
    nodes carrying the topology key. Per-domain counts are taken once a
    cycle (cached in the CycleState); each call recounts only the
    candidate it is handed."""

    name = "PodTopologySpread"
    # cacheable only because the planner bypasses the cache for a pod with
    # spread constraints: on the cached path the verdict is a constant ok
    verdict_cacheable = True
    _CACHE_KEY = "pod_topology_spread_counts"

    @staticmethod
    def _matching(info: NodeInfo, constraint) -> int:
        return sum(1 for p in info.pods if constraint.selects(p.labels))

    def _cycle_counts(self, state: CycleState, constraints) -> List[Dict]:
        """Per constraint: {'domains': {domain: matching}, 'per_node':
        {node: (domain, matching)}} over the published view."""
        cached = state.get(self._CACHE_KEY)
        if cached is not None:
            return cached
        computed = []
        for c in constraints:
            domains: Dict[str, int] = {}
            per_node: Dict[str, tuple] = {}
            for info in state.get(TOPOLOGY_NODE_INFOS_KEY) or []:
                domain = info.node.labels.get(c.topology_key)
                if domain is None:
                    continue
                n = self._matching(info, c)
                domains[domain] = domains.get(domain, 0) + n
                per_node[info.name] = (domain, n)
            computed.append({"domains": domains, "per_node": per_node})
        state[self._CACHE_KEY] = computed
        return computed

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        constraints = _hard_spread(pod)
        if not constraints:
            return Status.ok()
        labels = node_info.node.labels
        for c, cached in zip(constraints, self._cycle_counts(state, constraints)):
            if c.topology_key not in labels:
                return Status.unschedulable(f"node has no {c.topology_key} label", self.name)
            counts = dict(cached["domains"])
            candidate = labels[c.topology_key]
            # the handed-in view of the node replaces its published one
            pub_domain, pub_n = cached["per_node"].get(node_info.name, (candidate, 0))
            counts[pub_domain] = counts.get(pub_domain, 0) - pub_n
            counts[candidate] = counts.get(candidate, 0) + self._matching(node_info, c)
            if c.selects(pod.labels):
                counts[candidate] += 1
            skew = counts[candidate] - min(counts.values())
            if skew > c.max_skew:
                return Status.unschedulable(
                    f"placing on {c.topology_key}={candidate} would skew {skew} > "
                    f"maxSkew {c.max_skew}", self.name)
        return Status.ok()


class InterPodAffinityFit:
    """Required pod affinity and anti-affinity over the published view.
    An affinity term needs a matching pod in the candidate's domain, but a
    term matching the pod's own labels passes when no pod matches anywhere
    (a self-affine group's first replica). An anti-affinity term refuses a
    domain holding a matching pod, and an existing pod's anti-affinity
    refuses the incoming pod from its domain (symmetry; positive affinity
    is not symmetric). The symmetric entries and the pod's own terms'
    match locations are indexed once a cycle; each call rescans only the
    candidate's handed-in view."""

    name = "InterPodAffinity"
    # cacheable only under the planner's bypass: lookups are skipped while
    # the pod has terms or any placed pod has required anti-affinity, and
    # on the cached path the verdict is a constant ok
    verdict_cacheable = True
    _CACHE_KEY = "inter_pod_affinity_index"
    _TERM_CACHE_KEY = "inter_pod_affinity_term_index"

    @staticmethod
    def _anti_entries(info: NodeInfo) -> list:
        labels = info.node.labels
        return [(term, p.namespace, labels[term.topology_key])
                for p in info.pods for term in p.pod_anti_affinity
                if term.topology_key in labels]

    def _index(self, state: CycleState) -> list:
        """Every published pod's anti-affinity entries, [(node, term,
        owner ns, domain)]."""
        cached = state.get(self._CACHE_KEY)
        if cached is None:
            cached = [(info.name,) + entry for info in state.get(TOPOLOGY_NODE_INFOS_KEY) or []
                      for entry in self._anti_entries(info)]
            state[self._CACHE_KEY] = cached
        return cached

    def _term_index(self, state: CycleState, pod: Pod) -> Dict[int, tuple]:
        """Per term of the pod: (node → holds a match, domain → nodes
        holding one, nodes holding one)."""
        cached = state.get(self._TERM_CACHE_KEY)
        if cached is not None:
            return cached
        cached = {}
        for term in list(pod.pod_affinity) + list(pod.pod_anti_affinity):
            if id(term) in cached:
                continue
            node_hit: Dict[str, bool] = {}
            domain_hits: Dict[str, int] = {}
            total = 0
            for info in state.get(TOPOLOGY_NODE_INFOS_KEY) or []:
                hit = any(term.selects(p.labels, p.namespace, pod.namespace)
                          for p in info.pods)
                node_hit[info.name] = hit
                if hit:
                    total += 1
                    domain = info.node.labels.get(term.topology_key)
                    if domain is not None:
                        domain_hits[domain] = domain_hits.get(domain, 0) + 1
            cached[id(term)] = (node_hit, domain_hits, total)
        state[self._TERM_CACHE_KEY] = cached
        return cached

    def _excluded_by(self, entries, pod: Pod, labels: Dict[str, str]) -> Optional[Status]:
        for term, owner_ns, domain in entries:
            if labels.get(term.topology_key) == domain and term.selects(
                    pod.labels, pod.namespace, owner_ns):
                return Status.unschedulable(
                    f"an existing pod's anti-affinity ({term.topology_key}={domain}) "
                    "excludes this pod", self.name)
        return None

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        labels = node_info.node.labels
        # the published entries of the other nodes, then the handed-in
        # view's own
        others = [entry[1:] for entry in self._index(state) if entry[0] != node_info.name]
        refused = self._excluded_by(others + self._anti_entries(node_info), pod, labels)
        if refused is not None:
            return refused
        if not pod.pod_affinity and not pod.pod_anti_affinity:
            return Status.ok()
        term_index = self._term_index(state, pod)

        def here(term) -> bool:
            return any(term.selects(p.labels, p.namespace, pod.namespace)
                       for p in node_info.pods)

        for term in pod.pod_affinity:
            domain = labels.get(term.topology_key)
            if domain is None:
                return Status.unschedulable(f"node has no {term.topology_key} label",
                                            self.name)
            node_hit, domain_hits, total = term_index[id(term)]
            published = 1 if node_hit.get(node_info.name) else 0
            hit = here(term)
            if hit or domain_hits.get(domain, 0) - published > 0:
                continue
            if not (hit or total - published > 0) and term.selects(
                    pod.labels, pod.namespace, pod.namespace):
                continue  # the bootstrap: a self-affine group's first replica
            return Status.unschedulable(
                f"no pod matching affinity term in {term.topology_key}={domain}", self.name)
        for term in pod.pod_anti_affinity:
            domain = labels.get(term.topology_key)
            if domain is None:
                continue  # no domain, nothing to collide with
            node_hit, domain_hits, _ = term_index[id(term)]
            published = 1 if node_hit.get(node_info.name) else 0
            if here(term) or domain_hits.get(domain, 0) - published > 0:
                return Status.unschedulable(
                    f"anti-affinity: matching pod already in {term.topology_key}={domain}",
                    self.name)
        return Status.ok()


class TaintTolerationScoring:
    """Fewer untolerated PreferNoSchedule taints score higher."""

    name = "TaintTolerationScore"

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        untolerated = sum(
            1 for taint in node_info.node.taints
            if taint.effect == "PreferNoSchedule"
            and not any(t.tolerates(taint) for t in pod.tolerations))
        return max(0, 20 - 10 * untolerated)


class PodTopologySpreadScoring:
    """ScheduleAnyway spread constraints: a domain with fewer matching pods
    scores higher, and nothing is refused. Domain counts are taken once a
    cycle."""

    name = "PodTopologySpreadScore"
    _CACHE_KEY = "pod_topology_spread_score_counts"

    def _domain_counts(self, state: CycleState, constraints) -> List[Dict[str, int]]:
        cached = state.get(self._CACHE_KEY)
        if cached is not None:
            return cached
        computed = []
        for c in constraints:
            domains: Dict[str, int] = {}
            for info in state.get(TOPOLOGY_NODE_INFOS_KEY) or []:
                domain = info.node.labels.get(c.topology_key)
                if domain is not None:
                    domains[domain] = domains.get(domain, 0) + PodTopologySpreadFit._matching(
                        info, c)
            computed.append(domains)
        state[self._CACHE_KEY] = computed
        return computed

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        constraints = [c for c in pod.topology_spread_constraints
                       if c.when_unsatisfiable == "ScheduleAnyway"]
        if not constraints:
            return 0
        total = 0
        for c, domains in zip(constraints, self._domain_counts(state, constraints)):
            domain = node_info.node.labels.get(c.topology_key)
            if domain is None:
                continue
            count = domains.get(domain, PodTopologySpreadFit._matching(node_info, c))
            total += round(20 / (1 + count))
        return total // len(constraints)


def vanilla_filter_plugins() -> List[FilterPlugin]:
    """The predicates both the scheduler and the planner's simulation run,
    in the reference's order: keeping the two aligned keeps the planner
    from carving slices the scheduler would refuse."""
    return [NodeUnschedulableFit(), TaintTolerationFit(), NodeAffinityFit(),
            NodeSelectorFit(), PodTopologySpreadFit(), InterPodAffinityFit(),
            NodeResourcesFit()]
