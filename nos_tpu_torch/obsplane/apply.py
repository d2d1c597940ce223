"""An ``ObservabilityConfig`` onto the process's telemetry: counterpart of
``nos_tpu/obsplane/apply.py``."""
from __future__ import annotations

from typing import Callable

from nos_tpu_torch.obsplane import governor


def apply_observability(obs, registry=None, tracer=None) -> Callable[[], None]:
    """Apply the series budgets and the trace retention; a callable that
    puts back what was there (the registry and tracer are process-wide:
    call it in a ``finally``)."""
    from nos_tpu_torch.util import metrics as metrics_mod
    from nos_tpu_torch.util import tracing as tracing_mod

    registry = registry if registry is not None else metrics_mod.REGISTRY
    tracer = tracer if tracer is not None else tracing_mod.TRACER
    budgets, default = governor.budgets_from(obs)
    prev_budgets = registry.apply_series_budgets(budgets, default=default)
    prev_policy = tracer.store.set_retention(tracing_mod.RetentionPolicy(
        tail_capacity=obs.trace_tail_capacity, boring_sample_n=obs.trace_boring_sample_n,
        slow_thresholds=dict(obs.trace_slow_thresholds)))

    def revert() -> None:
        registry.restore_series_budgets(prev_budgets)
        tracer.store.set_retention(prev_policy)

    return revert
