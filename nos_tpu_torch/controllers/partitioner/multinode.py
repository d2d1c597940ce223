"""Multi-node expansion: a plain GPU request larger than one node becomes
a gang of whole-GPU MIG members.

Counterpart of ``nos_tpu/controllers/partitioner/multihost.py``
(``MultihostExpander``, ``expand_leader_in_place``, ``_rewrite_requests``,
``worker_from_leader``). The reference turns ``google.com/tpu: N`` past
one board into the smallest multi-host TPU topology; on H100 NVLink ends
at the node and no torus shape constrains the count, so a pod asking
``nvidia.com/gpu: N`` with N above the MIG fleet's GPUs per node (G)
becomes ``ceil(N / G)`` members, each asking ``G x nvidia.com/mig-7g.80gb``
(a whole GPU per instance). The expander:

1. labels the pod the gang's leader (``nos.nebuly.com/gang`` = its name,
   ``gang-size``, ``multihost-role: leader``) and annotates the shape,
   ``nos.nebuly.com/multihost-topology: "<members>x<G>"``;
2. rewrites its request to its share and gives it the DNS identity
   (hostname, and the subdomain of the gang's headless Service) and the
   distributed-init env of rank 0;
3. creates the Service and the ``members - 1`` workers, owned by the
   leader, each with its rank.

Everything downstream composes: the planner carves every member's GPUs in
one plan (its gang pre-pass refuses partial gangs), ``GangScheduling``
binds the gang at once, ``MultinodeFilter`` keeps it in one node pool,
and preemption evicts it whole. A MIG instance has no GPU-to-GPU peer
access, so a gang on 7g.80gb instances talks through the host or the
network, even inside a node.

``reconcile(req)`` is the reference's reconcile of one pod (expand a
pending oversized pod, ensure a leader's Service and workers,
garbage-collect a worker whose leader is gone: the owner-reference
contract), fed by the pod watch through ``leader_deleted_mapper``, which
maps a leader's deletion to its workers (the multi-node expander of
``cmd/partitioner.py``). ``SimCluster`` polls: ``step()`` reconciles
every pod. The in-process admission seam is ``admit``, registered with
``NodeStore.register_admission``: it expands a pod as it is created, so
the pod never exists un-expanded. A real API server allows the rewrite
only at admission: ``admission_mutate_pod`` gives the JSONPatch of the
mutating webhook (``kube/webhook.py``'s ``/mutate-v1-pod``), computed
against the pod's own wire document so the fields the flat pod does not
model survive. Over the API-backed store a worker is built from the
leader's whole wire document (``worker_wire_from_leader``). The env
names and the default port are the reference's, kept here as this
module's own copy (``parallel/distributed.py`` imports torch).
"""
from __future__ import annotations

import copy
import json
import logging
import math
from typing import List, Optional, Tuple

from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, KNOWN_GPUS
from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, PARTITIONING_MIG, RESOURCE_GPU, mig_resource
from nos_tpu_torch.kube.controller import Request, Result
from nos_tpu_torch.kube.store import (
    DELETED,
    AlreadyExistsError,
    NodeStore,
    NotFoundError,
    OwnerReference,
    Pod,
    PodPhase,
    Service,
    WatchEvent,
)
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from nos_tpu_torch.scheduler.plugins.topology import MULTINODE_TOPOLOGY_ANNOTATION

log = logging.getLogger("nos_tpu_torch.multinode")

MULTINODE_ROLE_LABEL = "nos.nebuly.com/multihost-role"
ROLE_LEADER = "leader"
ROLE_WORKER = "worker"

COORDINATOR_ENV = "NOS_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "NOS_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "NOS_TPU_PROCESS_ID"
DEFAULT_COORDINATOR_PORT = 8476


def gang_member_env(leader: str, namespace: str, rank: int, size: int,
                    port: int = DEFAULT_COORDINATOR_PORT) -> dict:
    """Member ``rank``'s coordinates: the coordinator is the leader's
    stable DNS name under the headless Service named after the gang."""
    return {COORDINATOR_ENV: f"{leader}.{leader}.{namespace}.svc:{port}",
            NUM_PROCESSES_ENV: str(size), PROCESS_ID_ENV: str(rank)}


def whole_gpu_profile(product: str) -> str:
    """The MIG profile spanning a whole GPU (7g.80gb on an H100)."""
    spec = KNOWN_GPUS[product]
    return next(p.name for p in spec.profiles if p.memory_slices == spec.memory_slices)


class MultinodeExpander:
    def __init__(self, store: NodeStore) -> None:
        self.store = store
        self.expansions = 0

    # --------------------------------------------------------------- util

    def _cluster_gpu(self) -> Optional[Tuple[str, int]]:
        """(product, GPUs per node) of the MIG fleet: the first MIG node's
        (a heterogeneous fleet would name its target on the pod)."""
        for node in self.store.list("Node", copy=False):
            product = node.labels.get(GPU_PRODUCT_LABEL)
            gpus = int(node.capacity.get(RESOURCE_GPU, 0))
            if (product in KNOWN_GPUS and gpus > 0
                    and node.labels.get(PARTITIONING_LABEL) == PARTITIONING_MIG):
                return product, gpus
        return None

    @staticmethod
    def _oversized_gpus(pod: Pod, gpus_per_node: int) -> int:
        """The plain GPU request when it exceeds one node, else 0."""
        gpus = int(pod.request.get(RESOURCE_GPU, 0))
        return gpus if gpus > gpus_per_node else 0

    def _expansion(self, pod: Pod) -> Optional[Tuple[str, int, int]]:
        """(product, GPUs per node, members) when ``pod`` is to be
        expanded, else None."""
        if (not pod.request.get(RESOURCE_GPU) or pod.labels.get(MULTINODE_ROLE_LABEL)
                or pod.node or pod.phase != PodPhase.PENDING):
            return None
        fleet = self._cluster_gpu()
        if fleet is None:
            return None
        product, per_node = fleet
        gpus = self._oversized_gpus(pod, per_node)
        if gpus <= 0:
            return None
        return product, per_node, math.ceil(gpus / per_node)

    # ------------------------------------------------------------- admission

    def admit(self, pod: Pod, store: NodeStore) -> None:
        """The mutating admission seam: expand ``pod`` as it is written."""
        expansion = self._expansion(pod)
        if expansion is not None:
            expand_leader_in_place(pod, *expansion)
            self.expansions += 1

    # ------------------------------------------------------------------ step

    def step(self) -> int:
        """Reconcile every pod; the pods expanded."""
        return sum(self._reconcile_pod(pod) for pod in self.store.list("Pod", copy=False))

    def reconcile(self, req: Request) -> Optional[Result]:
        """The reference's reconcile of one pod."""
        pod = self.store.try_get("Pod", req.name, req.namespace, copy=False)
        if pod is not None:
            self._reconcile_pod(pod)
        return None

    def _reconcile_pod(self, pod: Pod) -> bool:
        """Collect an orphan worker, complete a leader's gang, or expand;
        whether the pod was expanded."""
        role = pod.labels.get(MULTINODE_ROLE_LABEL)
        if role == ROLE_WORKER:
            self._gc_orphan_worker(pod)
        elif role == ROLE_LEADER:
            self._ensure_service(pod)
            self._ensure_workers(pod)
        else:
            return self._expand(pod)
        return False

    def _expand(self, pod: Pod) -> bool:
        expansion = self._expansion(pod)
        if expansion is None:
            return False
        try:
            leader = self.store.patch_merge(
                "Pod", pod.name, pod.namespace,
                lambda p: expand_leader_in_place(p, *expansion))
        except NotFoundError:
            return False
        self._ensure_service(leader)
        self._ensure_workers(leader)
        self.expansions += 1
        log.info("%s: expanded to a gang of %d members of %d GPUs", pod.namespaced_name,
                 expansion[2], expansion[1])
        return True

    def _ensure_service(self, leader: Pod) -> None:
        """The gang's headless Service: a DNS record per member
        (``<hostname>.<gang>.<ns>.svc``), so the coordinator resolves."""
        gang = leader.labels.get(GANG_NAME_LABEL, "")
        if not gang or self.store.try_get("Service", gang, leader.namespace, copy=False):
            return
        try:
            self.store.create(Service(
                gang, leader.namespace, selector={GANG_NAME_LABEL: gang},
                ports={"coordinator": DEFAULT_COORDINATOR_PORT},
                owner=OwnerReference("Pod", leader.name, leader.uid)))
        except AlreadyExistsError:
            pass

    def _ensure_workers(self, leader: Pod) -> None:
        """Create the leader's missing workers (idempotent)."""
        try:
            size = int(leader.labels.get(GANG_SIZE_LABEL, "0"))
        except ValueError:
            return
        raw_get = getattr(self.store, "raw_get", None)
        leader_wire = None
        for rank in range(1, size):
            name = f"{leader.name}-w{rank}"
            if self.store.try_get("Pod", name, leader.namespace, copy=False) is not None:
                continue
            if raw_get is not None and leader_wire is None:
                try:
                    leader_wire = raw_get("Pod", leader.name, leader.namespace)
                except Exception:  # noqa: BLE001 - the flat pod will do
                    leader_wire = {}
            try:
                if leader_wire:
                    self.store.raw_create("Pod", worker_wire_from_leader(leader_wire, rank,
                                                                         size))
                else:
                    self.store.create(worker_from_leader(leader, rank, size))
            except AlreadyExistsError:
                pass

    def _gc_orphan_worker(self, worker: Pod) -> None:
        """A worker and the gang's Service follow their leader: when the
        leader is gone, both are deleted."""
        ref = worker.owner
        if ref is None or ref.kind != "Pod":
            return
        if self.store.try_get("Pod", ref.name, worker.namespace, copy=False) is not None:
            return
        for kind, name in (("Pod", worker.name), ("Service", ref.name)):
            try:
                self.store.delete(kind, name, worker.namespace)
                log.info("%s %s/%s: garbage-collected (leader %s gone)", kind,
                         worker.namespace, name, ref.name)
            except NotFoundError:
                pass


def leader_deleted_mapper(store: NodeStore):
    """The expander's pod watch mapper: a leader's deletion maps to the
    workers it owns (their collection needs no poll), every other event
    to its own pod."""
    def mapper(event: WatchEvent) -> List[Request]:
        pod = event.object
        if event.type != DELETED or pod.labels.get(MULTINODE_ROLE_LABEL) != ROLE_LEADER:
            return [Request(pod.name, pod.namespace)]
        return [Request(p.name, p.namespace)
                for p in store.list("Pod", namespace=pod.namespace, copy=False)
                if p.owner is not None and p.owner.kind == "Pod"
                and p.owner.name == pod.name]

    return mapper


def register_multinode_admission(store: NodeStore) -> MultinodeExpander:
    """An expander whose ``admit`` runs on every pod created in ``store``."""
    expander = MultinodeExpander(store)
    store.register_admission("Pod", expander.admit)
    return expander


# --------------------------------------------------------- the pod rewrite


def expand_leader_in_place(pod: Pod, product: str, gpus_per_node: int, members: int) -> None:
    """The leader's rewrite: gang labels, the shape annotation, its share
    of whole-GPU instances, the DNS identity and rank 0's env."""
    gang = pod.name
    pod.labels[GANG_NAME_LABEL] = gang
    pod.labels[GANG_SIZE_LABEL] = str(members)
    pod.labels[MULTINODE_ROLE_LABEL] = ROLE_LEADER
    pod.annotations[MULTINODE_TOPOLOGY_ANNOTATION] = f"{members}x{gpus_per_node}"
    _rewrite_requests(pod, mig_resource(whole_gpu_profile(product)), gpus_per_node)
    pod.hostname = pod.name
    pod.subdomain = gang  # the headless Service of the same name
    pod.env.update(gang_member_env(gang, pod.namespace, 0, members))


def _rewrite_requests(pod: Pod, instance: str, per_member: int) -> None:
    """The plain GPU request becomes ``per_member`` whole-GPU instances
    (the port's pod has one request map: its limits are its requests)."""
    pod.request.pop(RESOURCE_GPU, None)
    pod.request[instance] = pod.request.get(instance, 0) + per_member


def worker_from_leader(leader: Pod, rank: int, size: int) -> Pod:
    """Worker ``rank``: the leader's spec, its own name, hostname and env,
    owned by the leader."""
    name = f"{leader.name}-w{rank}"
    labels = {k: v for k, v in leader.labels.items() if k != MULTINODE_ROLE_LABEL}
    labels[MULTINODE_ROLE_LABEL] = ROLE_WORKER
    worker = copy.deepcopy(leader)
    worker.name = name
    worker.labels = labels
    worker.annotations = {MULTINODE_TOPOLOGY_ANNOTATION:
                          leader.annotations.get(MULTINODE_TOPOLOGY_ANNOTATION, "")}
    worker.owner = OwnerReference("Pod", leader.name, leader.uid)
    worker.node = ""
    worker.phase = PodPhase.PENDING
    worker.unschedulable = False
    worker.unschedulable_message = ""
    worker.nominated_node = ""
    worker.uid = ""
    worker.created = None
    worker.hostname = name
    worker.env.update(gang_member_env(leader.name, leader.namespace, rank, size))
    return worker



def worker_wire_from_leader(leader_wire: dict, rank: int, size: int) -> dict:
    """Worker ``rank``'s wire document, built from the leader's whole wire
    document: every field the flat pod does not model carries over."""
    wire = json.loads(json.dumps(leader_wire))
    meta = wire.get("metadata") or {}
    leader, namespace = meta.get("name", ""), meta.get("namespace", "")
    name = f"{leader}-w{rank}"
    labels = dict(meta.get("labels") or {})
    labels[MULTINODE_ROLE_LABEL] = ROLE_WORKER
    wire["metadata"] = {
        "name": name, "namespace": namespace, "labels": labels,
        "annotations": {MULTINODE_TOPOLOGY_ANNOTATION: (meta.get("annotations") or {}).get(
            MULTINODE_TOPOLOGY_ANNOTATION, "")},
        "ownerReferences": [{"apiVersion": "v1", "kind": "Pod", "name": leader,
                             "uid": meta.get("uid", ""), "controller": True}]}
    wire.pop("status", None)
    spec = wire.setdefault("spec", {})
    spec.pop("nodeName", None)
    spec["hostname"] = name
    env_vars = gang_member_env(leader, namespace, rank, size)
    for container in spec.get("containers") or []:
        env = [e for e in container.get("env") or [] if e.get("name") not in env_vars]
        env.extend({"name": k, "value": v} for k, v in sorted(env_vars.items()))
        container["env"] = env
    return wire


def admission_mutate_pod(wire_pod: dict, store: NodeStore) -> Optional[List[dict]]:
    """The mutating webhook's JSONPatch expanding an oversized pod at
    admission, or None when it needs none. The ops are computed against
    the pod's own wire document, so the fields the flat pod does not model
    survive."""
    from nos_tpu_torch.kube import serde
    from nos_tpu_torch.kube.apistore import _overlay_containers

    pod = serde.pod_from_wire(wire_pod)
    expansion = MultinodeExpander(store)._expansion(pod)
    if expansion is None:
        return None
    expand_leader_in_place(pod, *expansion)
    projected = serde.pod_to_wire(pod)
    ops = [{"op": "add", "path": f"/metadata/{key}",
            "value": {**((wire_pod.get("metadata") or {}).get(key) or {}),
                      **(projected["metadata"].get(key) or {})}}
           for key in ("labels", "annotations")]
    ops.append({"op": "replace", "path": "/spec/containers",
                "value": _overlay_containers((wire_pod.get("spec") or {}).get("containers"),
                                             projected["spec"].get("containers"))})
    ops.append({"op": "add", "path": "/spec/hostname", "value": pod.hostname})
    ops.append({"op": "add", "path": "/spec/subdomain", "value": pod.subdomain})
    return ops
