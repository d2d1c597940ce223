"""Equivalence-class filter-verdict cache for the planner's simulation.

Counterpart of ``nos_tpu/partitioning/core/verdict_cache.py``. The planner
runs the scheduler framework (PreFilter + Filter) once per (pod,
candidate node) trial, thousands of times a plan, on heavily repeated
inputs; a verdict depends only on the pod's signature and the node's
state, so a repeated trial reads the cache instead of the plugin chain.

Key: ``(pod signature, node name, node version)``. The signature holds
every pod field the cacheable predicates read: the request, namespace,
labels, node, node selector, tolerations and required node affinity
(``:43-68``). The node name pins the node's static state (labels,
taints, cordon), and ``SnapshotNode.version`` its mutable state
(geometry, placed pods): versions come from a clock that never repeats
(``snapshot.py``), so a (name, version) pair never names two states, and
a reverted trial restores the old version, making the old entries valid
again.

A verdict that reads other nodes cannot be keyed by one node's state:
the planner bypasses the cache when the pod has spread or inter-pod
(anti-)affinity terms (``needs_cluster_context``, ``:71-80``), or when a
pod placed in the snapshot has required anti-affinity (symmetric terms
refuse incoming pods). A plugin takes part only if it sets
``verdict_cacheable = True``; the others run fresh on every trial, after
the cached verdict.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from nos_tpu_torch.kube.store import Pod


def pod_signature(pod: Pod) -> tuple:
    """The hashable equivalence class of the pod fields the cacheable
    predicates read."""
    return (
        tuple(sorted(pod.request.items())),
        pod.namespace,
        tuple(sorted(pod.labels.items())),
        pod.node,
        tuple(sorted(pod.node_selector.items())),
        tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations),
        tuple(tuple((r.key, r.operator, tuple(r.values)) for r in term.match_expressions)
              for term in pod.node_affinity),
    )


def needs_cluster_context(pod: Pod) -> bool:
    """The pod's own terms make its verdict read nodes other than the
    candidate: the per-pod half of the bypass."""
    return bool(pod.topology_spread_constraints or pod.pod_affinity
                or pod.pod_anti_affinity)


class VerdictCache:
    """One plan()'s verdict memo and its hit / miss / bypass ledger.
    Entries need no eviction within a plan: the version keys make a stale
    entry unreachable, never wrong."""

    __slots__ = ("entries", "hits", "misses", "bypasses")

    def __init__(self) -> None:
        self.entries: Dict[Tuple[tuple, str, int], bool] = {}
        self.hits = 0
        self.misses = 0
        self.bypasses = 0

    def get(self, key: Tuple[tuple, str, int]) -> Optional[bool]:
        """The cached verdict, counted as a hit or a miss; a miss must be
        followed by ``put``."""
        verdict = self.entries.get(key)
        if verdict is None:
            self.misses += 1
        else:
            self.hits += 1
        return verdict

    def put(self, key: Tuple[tuple, str, int], verdict: bool) -> None:
        self.entries[key] = verdict

    def stats(self) -> Tuple[int, int, int]:
        return (self.hits, self.misses, self.bypasses)

    def reset_stats(self) -> None:
        """Zero the ledger, keeping the entries: an incremental plan keeps
        the still-valid ones, its counts stay its own."""
        self.hits = 0
        self.misses = 0
        self.bypasses = 0
