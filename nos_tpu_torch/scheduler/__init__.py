"""The scheduler: counterpart of ``nos_tpu/scheduler``, trimmed to the
framework, the vanilla predicates, the polled cycle and the quota
plugin with its preemptor (``framework``, ``scheduler``,
``plugins/capacity``, ``preemption``)."""
from nos_tpu_torch.scheduler.framework import (
    CycleState,
    Diagnosis,
    Framework,
    NodeInfo,
    NodeResourcesFit,
    NodeSelectorFit,
    NodeUnschedulableFit,
    Status,
    StatusCode,
    TaintTolerationFit,
    TaintTolerationScoring,
    vanilla_filter_plugins,
)
from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
from nos_tpu_torch.scheduler.scheduler import CycleOutcome, Scheduler, new_framework

__all__ = [
    "CapacityScheduling", "CycleOutcome", "CycleState", "Diagnosis", "Framework", "NodeInfo", "NodeResourcesFit",
    "NodeSelectorFit", "NodeUnschedulableFit", "Scheduler", "Status", "StatusCode",
    "TaintTolerationFit", "TaintTolerationScoring", "new_framework",
    "vanilla_filter_plugins",
]
