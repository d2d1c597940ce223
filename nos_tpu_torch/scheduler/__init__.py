"""The scheduler: counterpart of ``nos_tpu/scheduler``: the framework with
the vanilla predicates, the polled cycle with Permit, and the nos
plugins (``plugins/capacity`` with its preemptor, ``plugins/gang``,
``plugins/reservation``, ``plugins/topology``)."""
from nos_tpu_torch.scheduler.framework import (
    TOPOLOGY_NODE_INFOS_KEY,
    CycleState,
    Diagnosis,
    Framework,
    InterPodAffinityFit,
    NodeAffinityFit,
    NodeInfo,
    NodeResourcesFit,
    NodeSelectorFit,
    NodeUnschedulableFit,
    PodTopologySpreadFit,
    PodTopologySpreadScoring,
    Status,
    StatusCode,
    TaintTolerationFit,
    TaintTolerationScoring,
    vanilla_filter_plugins,
)
from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
from nos_tpu_torch.scheduler.plugins.gang import GangScheduling, gang_of
from nos_tpu_torch.scheduler.plugins.reservation import AutoscalerGraceScoring, BoardReservation
from nos_tpu_torch.scheduler.plugins.topology import MultinodeFilter, TopologyScoring
from nos_tpu_torch.scheduler.scheduler import CycleOutcome, Scheduler, new_framework

__all__ = [
    "AutoscalerGraceScoring", "BoardReservation", "CapacityScheduling", "CycleOutcome",
    "CycleState", "Diagnosis", "Framework", "GangScheduling", "InterPodAffinityFit",
    "MultinodeFilter", "NodeAffinityFit", "NodeInfo", "NodeResourcesFit", "NodeSelectorFit",
    "NodeUnschedulableFit", "PodTopologySpreadFit", "PodTopologySpreadScoring", "Scheduler",
    "Status", "StatusCode", "TOPOLOGY_NODE_INFOS_KEY", "TaintTolerationFit",
    "TaintTolerationScoring", "TopologyScoring", "gang_of", "new_framework",
    "vanilla_filter_plugins",
]
