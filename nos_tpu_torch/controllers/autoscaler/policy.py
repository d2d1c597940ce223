"""The autoscaling decision: a pure function, so the tests and the
reconciler call the same code.

Counterpart of ``nos_tpu/controllers/autoscaler/policy.py:38-133``,
unchanged in meaning. Scaling follows the measured SLO burn
(``slo/engine.py``'s two windows) and the queue depth:

- scale up: a fast-window burn above the threshold, or a backlog above
  the replicas' queue target;
- scale down: both windows burning low, the error budget above the
  spec's surplus floor, the backlog fitting one replica fewer, and the
  fleet stable a while;
- scale to zero: ``min_replicas == 0`` and no demand for the idle window
  (a standing SLO with no traffic is met vacuously and holds nothing);
- cold start: demand for a model at zero.

Every verdict stays within ``[min_replicas, max_replicas]`` and moves by
one replica at most, but a cold start, which jumps to
``max(1, min_replicas)``.
"""
from __future__ import annotations

from dataclasses import dataclass

from nos_tpu_torch.api.config import AutoscalerConfig
from nos_tpu_torch.api.v1alpha1.modelserving import ModelServingSpec
from nos_tpu_torch.controllers.autoscaler.signals import Signals

VERDICT_HOLD = "hold"
VERDICT_SCALE_UP = "scale-up"
VERDICT_SCALE_DOWN = "scale-down"
VERDICT_SCALE_TO_ZERO = "scale-to-zero"
VERDICT_COLD_START = "cold-start"


@dataclass(frozen=True)
class Decision:
    desired: int
    verdict: str
    reason: str


def _clamp(n: int, spec: ModelServingSpec) -> int:
    return max(spec.min_replicas, min(spec.max_replicas, n))


def decide(spec: ModelServingSpec, current: int, sig: Signals, cfg: AutoscalerConfig,
           now: float, last_transition_t: float = 0.0) -> Decision:
    """The desired replica count. ``current`` counts the replica pods
    that exist; ``last_transition_t`` is when desired last changed."""
    # one transition a timestamp: reconciles repeated at one instant must
    # not ladder the fleet on one observation
    if last_transition_t > 0.0 and now <= last_transition_t:
        return Decision(current, VERDICT_HOLD, "transition taken at this instant")

    demand = sig.queue_depth > 0 or (now - sig.last_request_t <= cfg.recent_activity_seconds)

    if current == 0:
        if demand:
            target = _clamp(max(1, spec.min_replicas), spec)
            return Decision(target, VERDICT_COLD_START,
                            f"demand while at zero (queue={sig.queue_depth})")
        if spec.min_replicas > 0:
            return Decision(spec.min_replicas, VERDICT_SCALE_UP, "below min_replicas")
        return Decision(0, VERDICT_HOLD, "no demand at zero")

    if current < spec.min_replicas:
        return Decision(spec.min_replicas, VERDICT_SCALE_UP, "below min_replicas")

    if current < spec.max_replicas:
        if sig.burn_fast > cfg.scale_up_burn_threshold:
            return Decision(_clamp(current + 1, spec), VERDICT_SCALE_UP,
                            f"fast burn {sig.burn_fast:.2f} > {cfg.scale_up_burn_threshold}")
        if sig.queue_depth > current * spec.target_queue_depth:
            return Decision(_clamp(current + 1, spec), VERDICT_SCALE_UP,
                            f"backlog {sig.queue_depth} > "
                            f"{current} x {spec.target_queue_depth}")

    idle_since = max(sig.last_request_t, last_transition_t)
    if (spec.min_replicas == 0 and not demand
            and now - idle_since >= spec.scale_to_zero_idle_seconds):
        return Decision(0, VERDICT_SCALE_TO_ZERO,
                        f"idle {now - idle_since:.0f}s >= "
                        f"{spec.scale_to_zero_idle_seconds:.0f}s")

    floor = max(1, spec.min_replicas)
    if (current > floor
            and sig.burn_fast < cfg.scale_down_burn_threshold
            and sig.burn_slow < cfg.scale_down_burn_threshold
            and sig.error_budget_remaining >= spec.scale_down_budget_surplus
            and sig.queue_depth <= (current - 1) * spec.target_queue_depth
            and now - last_transition_t >= cfg.scale_down_stable_seconds):
        return Decision(current - 1, VERDICT_SCALE_DOWN,
                        f"budget surplus {sig.error_budget_remaining:.2f} with "
                        f"burn {sig.burn_fast:.2f}/{sig.burn_slow:.2f}")

    return Decision(current, VERDICT_HOLD, "signals within band")
