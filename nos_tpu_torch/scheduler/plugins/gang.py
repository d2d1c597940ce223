"""Gang scheduling: a gang's members are placed all together, or none.

Counterpart of ``nos_tpu/scheduler/plugins/gang.py``: ``gang_of``
(``:35``) and ``GangScheduling`` (``:56-132``) over the Permit point, in
the coscheduling style. Each member reserves its node and waits; when the
last member arrives (members already bound count) the whole gang is
released to bind together; a gang that does not complete within the
timeout is handed back, every member unreserved and marked unschedulable
as a unit (``Scheduler.handle_gang_timeouts``).

Pods declare membership with labels, the keys of nos's API:
``nos.nebuly.com/gang`` (a name unique in the namespace) and
``nos.nebuly.com/gang-size``. The deadline is read from the store's
clock (``NodeStore.clock``; ``SimCluster``'s is virtual, so a run
replays), where the reference reads ``time.monotonic``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.scheduler.framework import CycleState, Status

GANG_NAME_LABEL = "nos.nebuly.com/gang"
GANG_SIZE_LABEL = "nos.nebuly.com/gang-size"


def gang_of(pod: Pod) -> Optional[Tuple[str, int]]:
    """(``namespace/name``, size), or None; a malformed size means no
    gang."""
    name = pod.labels.get(GANG_NAME_LABEL)
    if not name:
        return None
    try:
        size = int(pod.labels.get(GANG_SIZE_LABEL, ""))
    except ValueError:
        return None
    if size < 1:
        return None
    return f"{pod.namespace}/{name}", size


def is_bound_member(pod: Pod, namespace: str, name: str) -> bool:
    """Bound to a node, alive, and labelled a member of gang ``name``."""
    return (pod.namespace == namespace and pod.labels.get(GANG_NAME_LABEL) == name
            and bool(pod.node) and pod.phase in (PodPhase.PENDING, PodPhase.RUNNING))


@dataclass
class _WaitingGang:
    size: int
    deadline: float
    members: Dict[str, Tuple[Pod, str]] = field(default_factory=dict)  # key → (pod, node)


class GangScheduling:
    name = "GangScheduling"

    def __init__(self, store: NodeStore, wait_timeout_seconds: float = 30.0) -> None:
        self.store = store
        self.timeout = wait_timeout_seconds
        self._lock = threading.Lock()
        self._waiting: Dict[str, _WaitingGang] = {}

    # ----------------------------------------------------------- permit

    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        gang = gang_of(pod)
        if gang is None:
            return Status.ok()
        key, size = gang
        bound = self._bound_members(key)
        with self._lock:
            waiting = self._waiting.setdefault(
                key, _WaitingGang(size=size, deadline=self.store.clock() + self.timeout))
            waiting.members[pod.namespaced_name] = (pod, node_name)
            arrived = len(waiting.members) + bound
            if arrived >= size:
                return Status.ok()
            return Status.wait(f"gang {key}: {arrived}/{size} members placed", self.name)

    def release(self, pod: Pod) -> List[Tuple[Pod, str]]:
        """After a member's permit succeeds: every waiting member of its
        gang, (pod, node), to bind with it."""
        gang = gang_of(pod)
        if gang is None:
            return []
        with self._lock:
            waiting = self._waiting.pop(gang[0], None)
        return list(waiting.members.values()) if waiting is not None else []

    def forget(self, pod_key: str) -> None:
        """Drop a member that is gone from its gang's waiting set: it no
        longer counts as arrived, and a release does not bind it."""
        with self._lock:
            for key, waiting in list(self._waiting.items()):
                if waiting.members.pop(pod_key, None) is not None and not waiting.members:
                    del self._waiting[key]

    # ---------------------------------------------------------- timeout

    def expired_gangs(self) -> List[List[Tuple[Pod, str]]]:
        """The members of every gang whose deadline has passed, each gang
        dropped from the waiting set."""
        now = self.store.clock()
        with self._lock:
            keys = [k for k, g in self._waiting.items() if g.deadline <= now]
            return [list(self._waiting.pop(k).members.values()) for k in keys]

    def waiting_count(self) -> int:
        with self._lock:
            return sum(len(g.members) for g in self._waiting.values())

    def waiting_members(self, gang_key: str) -> List[Tuple[Pod, str]]:
        """(pod, node) of the members reserved in Permit: placements the
        store cannot show yet (no bind)."""
        with self._lock:
            waiting = self._waiting.get(gang_key)
            return list(waiting.members.values()) if waiting else []

    # ----------------------------------------------------------- helpers

    def _bound_members(self, gang_key: str) -> int:
        ns, name = gang_key.split("/", 1)
        return sum(1 for p in self.store.list("Pod", namespace=ns, copy=False)
                   if is_bound_member(p, ns, name))
