"""SliceTracker: the slices each pending pod still lacks.

Counterpart of ``nos_tpu/partitioning/core/tracker.py`` (reference
internal/partitioning/core/tracker.go:26-88). Pods draw, in the planner's
order, from ONE shared free pool: when two pods each want the one free
3g.40gb, the second lacks it (drawing each pod from the whole pool, as
the reference nos does, lets N pods hide behind one free slice and
stalls the planner). ``remove(pod)`` drops a pod the planner placed, and
``add(pod, lacking)`` puts one back (the planner's repair of fault F3,
ROADMAP.md); the lacking totals are kept current by each pod's share,
not summed again per candidate node. A plain ``nvidia.com/gpu`` request lacks
nothing here: no codec tracks it, so the reference's ``_convert_plain``
has no counterpart.

``split`` names the pods the pool covers whose slices no single node's
free slices hold (F3's pods): the free slices do not serve them, so the
planner runs a pass, where the reference would stop at an empty tracker.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from nos_tpu_torch.kube.store import Pod
from nos_tpu_torch.util import resources as res


class SliceTracker:
    def __init__(self, snapshot, pods: Iterable[Pod]) -> None:
        self._lacking: Dict[str, res.ResourceList] = {}
        self._totals: Optional[res.ResourceList] = None
        self.totals_calls = 0
        self.totals_recomputes = 0
        self.split: List[str] = []
        pool = snapshot.free_slice_resources()
        node_frees = None
        for pod in pods:
            request = res.compute_pod_request(pod)
            lacking = snapshot.take_from_pool(pool, request)
            if lacking:
                self._lacking[pod.namespaced_name] = lacking
                continue
            slices = snapshot.take_from_pool({}, request)
            if sum(slices.values()) < 2:
                continue  # a single slice lies on one node
            if node_frees is None:
                node_frees = [snapshot.codec_resources(node.partitionable.free_slices())
                              for node in snapshot.get_nodes().values()]
            if not any(all(free.get(k, 0) >= q for k, q in slices.items())
                       for free in node_frees):
                self.split.append(pod.namespaced_name)

    @property
    def empty(self) -> bool:
        return not self._lacking

    def __contains__(self, pod: Pod) -> bool:
        return pod.namespaced_name in self._lacking

    def pods_with_lacking_slices(self) -> List[str]:
        return sorted(self._lacking)

    def lacking_totals(self) -> res.ResourceList:
        """Every pending pod's lack, summed (a copy)."""
        self.totals_calls += 1
        if self._totals is None:
            self.totals_recomputes += 1
            total: res.ResourceList = {}
            for lacking in self._lacking.values():
                total = res.sum_resources(total, lacking)
            self._totals = total
        return dict(self._totals)

    def lacking_for(self, pod: Pod) -> res.ResourceList:
        """One pod's lack: what a carve for exactly this pod aims at."""
        return dict(self._lacking.get(pod.namespaced_name, {}))

    def add(self, pod: Pod, lacking: res.ResourceList) -> None:
        """Track ``pod`` as lacking ``lacking`` (it must not be tracked)."""
        self._lacking[pod.namespaced_name] = dict(lacking)
        if self._totals is not None:
            self._totals = res.sum_resources(self._totals, lacking)

    def remove(self, pod: Pod) -> None:
        lacking = self._lacking.pop(pod.namespaced_name, None)
        if lacking is None or self._totals is None:
            return
        for name, amount in lacking.items():
            remaining = self._totals.get(name, 0) - amount
            if remaining > 0:
                self._totals[name] = remaining
            else:
                self._totals.pop(name, None)
