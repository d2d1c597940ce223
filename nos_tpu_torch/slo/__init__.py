"""Serving SLOs: declarative specs, burn-rate evaluation, the open-loop
workload driver (a port of ``nos_tpu/slo``'s engine and driver) and the
serving SLO bench (``python -m nos_tpu_torch.slo.bench_serve``)."""
from nos_tpu_torch.slo.driver import (
    Arrival,
    ModelProfile,
    OpenLoopDriver,
    WorkloadConfig,
    build_arrivals,
)
from nos_tpu_torch.slo.engine import SLOEngine, SLOSpec

__all__ = [
    "Arrival",
    "ModelProfile",
    "OpenLoopDriver",
    "SLOEngine",
    "SLOSpec",
    "WorkloadConfig",
    "build_arrivals",
]
