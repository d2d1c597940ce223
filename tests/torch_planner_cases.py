"""Translated cases for the planner, scheduler and partitioner tests:
one description of nodes and pods, built on both sides.

nos_tpu's TPU nodes and the port's H100 nodes are held to each other
under the translation tests/test_torch_gpu_node.py uses: a v5e node with
one 2x4 board (8 chips) per GPU corresponds to an H100 node of as many
GPUs, topologies map to MIG profiles with as many memory slices
(``1x1 / 1x2 / 2x2 / 2x4`` ↔ ``1g.10gb / 2g.20gb / 4g.40gb / 7g.80gb``),
and the same allowed-geometry table goes through both
``set_known_geometries`` hooks. For MPS, one shared chip with an 80 GB
budget corresponds to one H100: ``google.com/tpu-mem-<N>gb`` ↔
``nvidia.com/gpu-<N>gb``. Descriptions are written in the port's names.
"""
import contextlib
import copy
import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nos_tpu.api.v1alpha1 import annotations as jannot
from nos_tpu.api.v1alpha1 import constants, labels
from nos_tpu.kube import objects as jobj
from nos_tpu.tpu import known as jknown
from nos_tpu.tpu.topology import enumerate_tilings
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.gpu import known as tknown
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, RESOURCE_GPU
from nos_tpu_torch.kube import store as tstore

V5E = "tpu-v5-lite-podslice"
H100 = tknown.H100_80GB
TO_MIG = {"1x1": "1g.10gb", "1x2": "2g.20gb", "2x2": "4g.40gb", "2x4": "7g.80gb"}
TO_TPU = {v: k for k, v in TO_MIG.items()}
MIG_PROFILES = tuple(TO_TPU)
GPU_LABELS = {tknown.GPU_PRODUCT_LABEL: H100}


@contextlib.contextmanager
def same_tables():
    """v5e's 2x4 tilings on the reference's side, their MIG images on the
    port's."""
    tilings = [dict(g) for g in enumerate_tilings("2x4", ("1x1", "1x2", "2x2", "2x4"))]
    jknown.set_known_geometries({V5E: tilings})
    tknown.set_known_geometries({H100: [{TO_MIG[p]: n for p, n in g.items()}
                                        for g in tilings]})
    try:
        yield [{TO_MIG[p]: n for p, n in g.items()} for g in tilings]
    finally:
        jknown.set_known_geometries(None)
        tknown.set_known_geometries(None)


@contextlib.contextmanager
def eighty_gb_chips():
    spec = jknown.KNOWN_ACCELERATORS[V5E]
    jknown.KNOWN_ACCELERATORS[V5E] = dataclasses.replace(spec, hbm_gb=80)
    try:
        yield
    finally:
        jknown.KNOWN_ACCELERATORS[V5E] = spec


# ------------------------------------------------------------ names

# the quotas' aggregate: GB for GB when the reference counts 10 GB a chip
GPU_MEMORY, TPU_MEMORY = "nos.nebuly.com/gpu-memory", constants.RESOURCE_TPU_MEMORY


def to_ref_resource(name: str) -> str:
    if name == GPU_MEMORY:
        return TPU_MEMORY
    if name.startswith("nvidia.com/mig-"):
        return constants.tpu_slice_resource(TO_TPU[name[len("nvidia.com/mig-"):]])
    if name.startswith("nvidia.com/gpu-"):
        return constants.tpu_shared_resource(name[len("nvidia.com/gpu-"):])
    return name


def to_port_resource(name: str) -> str:
    if name == TPU_MEMORY:
        return GPU_MEMORY
    if constants.is_tpu_slice_resource(name):
        return "nvidia.com/mig-" + TO_MIG[constants.tpu_slice_topology(name)]
    if constants.is_tpu_shared_resource(name):
        return "nvidia.com/gpu-" + constants.tpu_shared_profile(name)
    return name


_REF_NAME = re.compile(r"google\.com/tpu-(?:slice-\d+x\d+|mem-\d+gb)|nos\.nebuly\.com/tpu-memory")


# the reference's plugin names and wording where the port's differ
PLUGIN_NAMES = {"MultihostIci": "Multinode", "IciTopologyScoring": "TopologyScoring"}
_REF_WORDING = (("multi-host slice pinned to node pool", "multi-node gang pinned to node pool"),)


def translate_text(text: str) -> str:
    """A reference message with its resource names and wording in the
    port's form."""
    for ref, port in _REF_WORDING:
        text = text.replace(ref, port)
    return _REF_NAME.sub(lambda m: to_port_resource(m.group(0)), text)


def to_ref_profile(profile: str) -> str:
    return TO_TPU.get(profile, profile)


# ------------------------------------------------------------ descriptions

@dataclass
class NodeDesc:
    name: str
    gpus: int = 1
    free: Dict[int, Dict[str, int]] = field(default_factory=dict)  # port profiles
    used: Dict[int, Dict[str, int]] = field(default_factory=dict)
    mode: str = "mig"  # mig | mps
    taints: List[Tuple[str, str, str]] = field(default_factory=list)
    unschedulable: bool = False
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)  # port keys, extra
    cpu: int = 8


@dataclass
class PodDesc:
    name: str
    request: Dict[str, int] = field(default_factory=dict)  # port resource names
    ns: str = "default"
    priority: int = 0
    tolerations: List[Tuple[str, str, str, str]] = field(default_factory=list)
    selector: Dict[str, str] = field(default_factory=dict)
    node: str = ""
    phase: str = "Pending"
    unschedulable: bool = False
    labels: Dict[str, str] = field(default_factory=dict)
    created: Optional[float] = None  # the creation time both sides get
    # the scheduling terms, as the port's dataclasses (tstore.*)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_affinity: list = field(default_factory=list)  # NodeSelectorTerm
    pod_affinity: list = field(default_factory=list)  # PodAffinityTerm
    pod_anti_affinity: list = field(default_factory=list)
    spread: list = field(default_factory=list)  # TopologySpreadConstraint

    @property
    def key(self) -> str:
        return f"{self.ns}/{self.name}"


def _ref_geometries(geometries, mode):
    if mode == "mps":
        return {g: dict(p) for g, p in geometries.items()}
    return {g: {to_ref_profile(p): n for p, n in prof.items()} for g, prof in geometries.items()}


def ref_node(desc: NodeDesc) -> jobj.Node:
    chips = 8 * desc.gpus if desc.mode == "mig" else desc.gpus
    kind = "tpu" if desc.mode == "mig" else "sharing"
    alloc = {constants.RESOURCE_TPU: chips, "cpu": desc.cpu, "memory": 128}
    node_labels = {labels.GKE_TPU_ACCELERATOR_LABEL: V5E, labels.GKE_TPU_TOPOLOGY_LABEL: "2x4",
                   labels.PARTITIONING_LABEL: kind, **desc.labels}
    annotations = jannot.status_from_devices(_ref_geometries(desc.free, desc.mode),
                                             _ref_geometries(desc.used, desc.mode))
    for key, value in desc.annotations.items():
        annotations[key.replace("-gpu-", "-tpu-")] = value
    node = jobj.Node(metadata=jobj.ObjectMeta(name=desc.name, labels=node_labels,
                                              annotations=annotations),
                     status=jobj.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc)))
    node.spec.taints = [jobj.Taint(key=k, value=v, effect=e) for k, v, e in desc.taints]
    node.spec.unschedulable = desc.unschedulable
    return node


def port_node(desc: NodeDesc) -> tstore.Node:
    alloc = {RESOURCE_GPU: desc.gpus, "cpu": desc.cpu, "memory": 128}
    annotations = tannot.status_from_devices(desc.free, desc.used)
    annotations.update(desc.annotations)
    return tstore.Node(desc.name, labels={**GPU_LABELS, PARTITIONING_LABEL: desc.mode,
                                          **desc.labels},
                       capacity=dict(alloc), allocatable=dict(alloc), annotations=annotations,
                       taints=[tstore.Taint(k, v, e) for k, v, e in desc.taints],
                       unschedulable=desc.unschedulable)


def _ref_requirements(reqs):
    return [jobj.NodeSelectorRequirement(key=r.key, operator=r.operator, values=list(r.values))
            for r in reqs]


def ref_term(term: tstore.PodAffinityTerm) -> jobj.PodAffinityTerm:
    return jobj.PodAffinityTerm(topology_key=term.topology_key,
                                match_labels=dict(term.match_labels),
                                match_expressions=_ref_requirements(term.match_expressions),
                                namespaces=list(term.namespaces))


def ref_pod(desc: PodDesc) -> jobj.Pod:
    pod = jobj.Pod(
        metadata=jobj.ObjectMeta(name=desc.name, namespace=desc.ns),
        spec=jobj.PodSpec(
            containers=[jobj.Container(requests={to_ref_resource(k): v
                                                 for k, v in desc.request.items()})],
            priority=desc.priority, node_name=desc.node,
            scheduler_name=constants.SCHEDULER_NAME,
            tolerations=[jobj.Toleration(key=k, operator=o, value=v, effect=e)
                         for k, o, v, e in desc.tolerations],
            node_selector=dict(desc.selector)))
    pod.status.phase = desc.phase
    pod.metadata.labels.update(desc.labels)
    if desc.created is not None:
        pod.metadata.creation_timestamp = desc.created
    if desc.unschedulable:
        pod.status.conditions.append(jobj.PodCondition(type="PodScheduled", status="False",
                                                       reason="Unschedulable"))
    pod.metadata.annotations.update(desc.annotations)
    if desc.node_affinity:
        pod.spec.affinity = jobj.NodeAffinity(required_terms=[
            jobj.NodeSelectorTerm(match_expressions=_ref_requirements(t.match_expressions))
            for t in desc.node_affinity])
    pod.spec.pod_affinity = [ref_term(t) for t in desc.pod_affinity]
    pod.spec.pod_anti_affinity = [ref_term(t) for t in desc.pod_anti_affinity]
    pod.spec.topology_spread_constraints = [
        jobj.TopologySpreadConstraint(topology_key=c.topology_key, max_skew=c.max_skew,
                                      when_unsatisfiable=c.when_unsatisfiable,
                                      match_labels=dict(c.match_labels))
        for c in desc.spread]
    return pod


def port_pod(desc: PodDesc) -> tstore.Pod:
    return tstore.Pod(desc.name, desc.ns, node=desc.node, phase=desc.phase,
                      request=dict(desc.request), priority=desc.priority,
                      tolerations=[tstore.Toleration(k, o, v, e)
                                   for k, o, v, e in desc.tolerations],
                      node_selector=dict(desc.selector), unschedulable=desc.unschedulable,
                      labels=dict(desc.labels), created=desc.created,
                      annotations=dict(desc.annotations),
                      node_affinity=copy.deepcopy(desc.node_affinity),
                      pod_affinity=copy.deepcopy(desc.pod_affinity),
                      pod_anti_affinity=copy.deepcopy(desc.pod_anti_affinity),
                      topology_spread_constraints=copy.deepcopy(desc.spread))


# ------------------------------------------------------------ states

def port_state(state) -> Dict[str, tuple]:
    """A port PartitioningState, canonical: node → sorted GPU rows."""
    return {name: tuple(sorted((g.gpu_index, tuple(sorted(g.resources.items())))
                               for g in np.gpus if g.resources))
            for name, np in state.items()}


def ref_state(state) -> Dict[str, tuple]:
    """A reference PartitioningState in the port's names, canonical."""
    return {name: tuple(sorted((b.board_index,
                                tuple(sorted((to_port_resource(k), v)
                                             for k, v in b.resources.items())))
                               for b in np.boards if b.resources))
            for name, np in state.items()}


def ref_unserved(unserved: Dict[str, str]) -> Dict[str, str]:
    return {k: translate_text(v) for k, v in unserved.items()}


def translate_pool(pool: Dict[str, int]) -> Dict[str, int]:
    return {to_port_resource(k): v for k, v in pool.items() if v}


def nonzero(pool: Dict[str, int]) -> Dict[str, int]:
    return {k: v for k, v in pool.items() if v}


def running_pods(nodes: List[NodeDesc]) -> List[PodDesc]:
    """One running pod per used slice (so the scheduler view counts it)."""
    out = []
    for desc in nodes:
        for gpu, geometry in sorted(desc.used.items()):
            for profile, qty in sorted(geometry.items()):
                resource = (f"nvidia.com/mig-{profile}" if desc.mode == "mig"
                            else f"nvidia.com/gpu-{profile}")
                for k in range(qty):
                    out.append(PodDesc(f"run-{desc.name}-{gpu}-{profile}-{k}", {resource: 1},
                                       ns="run", node=desc.name, phase="Running"))
    return out
