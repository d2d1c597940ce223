"""ModelServing: a served model with its replica bounds and SLO targets.

Counterpart of ``nos_tpu/api/v1alpha1/modelserving.py:20-98``. The spec
names the model, the H100 MIG profile each replica occupies (``1g.10gb``
… ``7g.80gb``, ``gpu/known.py``; the reference's default ``"2x4"``, one
v5e board, becomes ``"7g.80gb"``, one H100), the replica bounds and the
SLO targets in ``slo/engine.py`` syntax. The autoscaler
(``controllers/autoscaler``) reconciles ``status.desired_replicas`` from
the measured burn rates and queue depth and acts through replica pods
alone. The port has no kube object model (``kube/store.py``), so the
kind is one dataclass: name, namespace, spec and status.

``chips_per_replica`` keeps the reference's name: a replica's size in
memory slices, the planner's unit (a ``7g.80gb`` counts 8, a
``3g.40gb`` 4), which under the parity tests' translation is the
reference's chip count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, List

from nos_tpu_torch.gpu.known import MIG_PROFILES

SCHEDULER_NAME = "nos-scheduler"
# the label tying replica pods to their ModelServing
# (``nos_tpu/api/v1alpha1/labels.py:31``)
MODEL_SERVING_LABEL = "nos.nebuly.com/model-serving"


@dataclass
class ModelServingSpec:
    # the model the router serves (slo/routing.py)
    model: str = ""
    # the MIG profile each replica's server pod occupies
    slice_profile: str = "7g.80gb"
    min_replicas: int = 0
    max_replicas: int = 1
    # SLO targets in slo/engine.py syntax
    slos: List[str] = field(default_factory=list)
    # scale to zero after this long with no arrival and an empty queue
    # (min_replicas == 0 only)
    scale_to_zero_idle_seconds: float = 300.0
    # after a scale to zero, the vacated nodes are held this long for the
    # model's cold start
    cold_start_grace_seconds: float = 60.0
    # a backlog above replicas x this scales up
    target_queue_depth: int = 4
    # scale down one replica only while this share of every SLO's error
    # budget remains
    scale_down_budget_surplus: float = 0.5
    scheduler_name: str = SCHEDULER_NAME

    def validate(self) -> None:
        from nos_tpu_torch.slo.engine import SLOSpec

        if not self.model:
            raise ValueError("spec.model must be set")
        if self.slice_profile not in MIG_PROFILES:
            raise ValueError(f"invalid slice_profile {self.slice_profile!r}: "
                             f"one of {', '.join(MIG_PROFILES)}")
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError("max_replicas must be >= max(1, min_replicas)")
        for text in self.slos:
            SLOSpec.parse(text)  # raises ValueError on bad syntax
        if self.scale_to_zero_idle_seconds < 0:
            raise ValueError("scale_to_zero_idle_seconds must be >= 0")
        if self.cold_start_grace_seconds < 0:
            raise ValueError("cold_start_grace_seconds must be >= 0")
        if self.target_queue_depth < 1:
            raise ValueError("target_queue_depth must be >= 1")
        if not 0.0 <= self.scale_down_budget_surplus <= 1.0:
            raise ValueError("scale_down_budget_surplus must be in [0, 1]")

    @property
    def chips_per_replica(self) -> int:
        """A replica's memory slices (a 7g.80gb counts 8)."""
        return MIG_PROFILES[self.slice_profile].memory_slices


@dataclass
class ModelServingStatus:
    # replica pods that exist / are bound to a node
    replicas: int = 0
    ready_replicas: int = 0
    # the reconciler's last target
    desired_replicas: int = 0
    # the last verdict, and when desired_replicas last changed
    last_verdict: str = ""
    last_transition_t: float = 0.0
    # set when scaling 0 -> N, cleared when the first replica binds
    cold_start_since: float = 0.0
    cold_starts: int = 0


@dataclass
class ModelServing:
    name: str
    namespace: str = "default"
    spec: ModelServingSpec = field(default_factory=ModelServingSpec)
    status: ModelServingStatus = field(default_factory=ModelServingStatus)
    kind: ClassVar[str] = "ModelServing"
