"""The scheduler framework: extension points, the cycle's scratch state,
the per-node rejection ledger and the vanilla predicates.

Counterpart of ``nos_tpu/scheduler/framework.py`` (the k8s scheduler
framework as the reference uses it): ``StatusCode`` / ``Status``
(``:20-53``), ``CycleState`` (``:54``), ``Diagnosis`` (``:59``),
``NodeInfo`` (``:106``), ``Framework`` (``:216``) with its PreFilter,
Filter, PostFilter, Score, Reserve and Unreserve runners, the ``verdict_cacheable`` marks
(``:173``), the filters ``NodeResourcesFit`` (``:323``),
``NodeSelectorFit`` (``:369``), ``TaintTolerationFit`` (``:404``) and
``NodeUnschedulableFit`` (``:424``), ``TaintTolerationScoring``
(``:714``) and ``vanilla_filter_plugins`` (``:779``).

The port's pod carries no affinity or topology-spread terms yet, so
``NodeAffinityFit``, ``PodTopologySpreadFit`` / ``Scoring`` and
``InterPodAffinityFit`` wait for a later slice (ROADMAP.md), as does
Permit (gangs). A pod's request is one map,
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


@dataclass
class NodeInfo:
    """A node and the pods placed on it."""

    node: Node
    pods: List[Pod] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.node.name

    def requested(self) -> res.ResourceList:
        total: res.ResourceList = {}
        for pod in self.pods:
            total = res.sum_resources(total, res.compute_pod_request(pod))
        return total

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
                 post_filter_plugins: Sequence[PostFilterPlugin] = ()) -> None:
        self.pre_filter_plugins = list(pre_filter_plugins)
        self.filter_plugins = list(filter_plugins)
        self.post_filter_plugins = list(post_filter_plugins)
        self.reserve_plugins = list(reserve_plugins)
        self.score_plugins = list(score_plugins)

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


class TaintTolerationScoring:
    """Fewer untolerated PreferNoSchedule taints score higher."""

    name = "TaintTolerationScore"

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        untolerated = sum(
            1 for taint in node_info.node.taints
            if taint.effect == "PreferNoSchedule"
            and not any(t.tolerates(taint) for t in pod.tolerations))
        return max(0, 20 - 10 * untolerated)


def vanilla_filter_plugins() -> List[FilterPlugin]:
    """The predicates both the scheduler and the planner's simulation run,
    in the reference's order: keeping the two aligned keeps the planner
    from carving slices the scheduler would refuse."""
    return [NodeUnschedulableFit(), TaintTolerationFit(), NodeSelectorFit(),
            NodeResourcesFit()]
