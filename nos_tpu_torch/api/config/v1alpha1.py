"""The autoscaler's configuration: counterpart of
``nos_tpu/api/config/v1alpha1.py:171-198`` (``AutoscalerConfig`` with
its ``validate``), without ``resync_seconds``: the polled reconciler has
no requeue. The reference's manager settings and the other components'
configs wait for the components' slice (ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass


class ConfigError(ValueError):
    pass


@dataclass
class AutoscalerConfig:
    # a fast-window burn above this adds a replica; scale-down needs both
    # windows below scale_down_burn_threshold, the spec's budget surplus,
    # and scale_down_stable_seconds since the last transition
    scale_up_burn_threshold: float = 1.0
    scale_down_burn_threshold: float = 0.5
    scale_down_stable_seconds: float = 120.0
    # a model counts as active (no scale to zero) this long after its
    # last arrival
    recent_activity_seconds: float = 30.0

    def validate(self) -> None:
        if self.scale_up_burn_threshold <= 0:
            raise ConfigError("scale_up_burn_threshold must be > 0")
        if not 0 <= self.scale_down_burn_threshold <= self.scale_up_burn_threshold:
            raise ConfigError(
                "scale_down_burn_threshold must be in [0, scale_up_burn_threshold]")
        if self.scale_down_stable_seconds < 0:
            raise ConfigError("scale_down_stable_seconds must be >= 0")
        if self.recent_activity_seconds < 0:
            raise ConfigError("recent_activity_seconds must be >= 0")
