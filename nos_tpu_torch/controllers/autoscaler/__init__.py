"""The SLO-driven model-serving autoscaler: counterpart of
``nos_tpu/controllers/autoscaler`` (polled).

A ModelServing declares a model, the MIG profile of each replica, the
replica bounds and the SLO targets; the reconciler sets the replicas
from the measured burn rates and queue depth and acts through pods
alone: the scheduler places them, the partitioner carves their slices,
the quotas arbitrate.

  policy.py      the pure decision (spec + signals → Decision)
  signals.py     the per-model signal registry the SLO engine and the
                 router feed
  controller.py  the ModelServing reconciler
"""
from nos_tpu_torch.controllers.autoscaler.controller import ModelServingReconciler
from nos_tpu_torch.controllers.autoscaler.policy import (
    VERDICT_COLD_START,
    VERDICT_HOLD,
    VERDICT_SCALE_DOWN,
    VERDICT_SCALE_TO_ZERO,
    VERDICT_SCALE_UP,
    Decision,
    decide,
)
from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry, Signals

__all__ = ["Decision", "ModelServingReconciler", "SignalRegistry", "Signals",
           "VERDICT_COLD_START", "VERDICT_HOLD", "VERDICT_SCALE_DOWN", "VERDICT_SCALE_TO_ZERO",
           "VERDICT_SCALE_UP", "decide"]
