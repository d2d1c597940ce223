"""The components' configurations: counterpart of
``nos_tpu/api/config/v1alpha1.py:21-270``.

Each component takes one ``--config <file>`` decoded into one of these,
with the reference's ``validate()`` and ``ConfigError``s (reference
cmd/gpupartitioner/gpupartitioner.go:90-101). The translation for H100
nodes:

- ``knownTpuGeometries`` becomes ``known_mig_geometries``: product →
  the allowed MIG geometries of one GPU (``gpu/known.py``'s
  ``set_known_geometries``), in place of the accelerator's board
  geometries.
- The operator's ``tpu_chip_memory_gb`` (16) becomes ``gpu_memory_gb``
  (80, an H100's): the GB a plain ``nvidia.com/gpu`` counts in the
  ``nos.nebuly.com/gpu-memory`` aggregate, as nos's
  ``nvidiaGpuResourceMemoryGB``.
- ``TpuAgentConfig`` becomes ``AgentConfig``, the MIG and the MPS agent's
  (their report interval).
- ``aging_chips_per_second`` becomes ``aging_per_second``: the planner's
  effective size, in slices, that a second passed over adds.

What the port's partitioner does not run is refused, never quietly
ignored: ``forecast_enabled`` and an ``audit_sample_rate`` above 0 raise
a ``ConfigError`` naming item 18b, which brings the forecaster's thread
and the auditor (their other knobs are validated as the reference's).
``pool_parallelism`` keeps the reference's values; its ``thread`` mode
plans serially (the port's deliberate difference: the planner is pure
Python, and threads plan no faster). ``ObservabilityConfig`` waits for
item 18b.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu_torch.api.v1alpha1.constants import SCHEDULER_NAME

# the H100's GB: what a plain nvidia.com/gpu counts as in quotas
H100_MEMORY_GB = 80
DEVICE_PLUGIN_CONFIG_MAP = "nos-device-plugin-config"
ITEM_18B = "item 18b (recording and observability)"


class ConfigError(ValueError):
    pass


@dataclass
class ManagerConfig:
    """The controller manager's endpoints and election (the reference's
    ControllerManagerConfigurationSpec embed)."""

    metrics_bind_address: str = ":8080"
    health_probe_bind_address: str = ":8081"
    leader_election: bool = False


@dataclass
class GpuPartitionerConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    batch_window_timeout_seconds: float = 60.0
    batch_window_idle_seconds: float = 10.0
    # product → the allowed geometries of one GPU, replacing the enumerated ones
    known_mig_geometries: Optional[Dict[str, List[Dict[str, int]]]] = None
    scheduler_config_file: str = ""
    device_plugin_config_map: str = DEVICE_PLUGIN_CONFIG_MAP
    # effective size (slices) a second of waiting adds in the planner's sort
    aging_per_second: float = 1.0
    # plan only for pods this scheduler binds; empty: every pod
    scheduler_name: str = SCHEDULER_NAME
    # the auditor's shadow replans: item 18b; above 0 is refused
    audit_sample_rate: float = 0.0
    incremental_planning: bool = True
    incremental_dirty_threshold: float = 0.25
    pool_sharding: bool = False
    # "serial" or "thread" (planned serially here)
    pool_parallelism: str = "serial"
    pool_max_workers: int = 0
    # "" follows pool_parallelism; "process": a worker process a pool
    pool_backend: str = ""
    pool_cycle_timeout_seconds: float = 5.0
    warm_state_path: str = ""
    warm_state_save_interval_seconds: float = 30.0
    # the forecaster's thread: item 18b; True is refused
    forecast_enabled: bool = False
    forecast_min_interval_seconds: float = 0.25
    forecast_max_gangs: int = 32
    forecast_max_backfill_pairs: int = 64
    forecast_small_pod_chips: int = 2

    def validate(self) -> None:
        if self.aging_per_second < 0:
            raise ConfigError("aging_per_second must be >= 0")
        if not 0.0 <= self.audit_sample_rate <= 1.0:
            raise ConfigError("audit_sample_rate must be in [0, 1]")
        if not 0.0 < self.incremental_dirty_threshold <= 1.0:
            raise ConfigError("incremental_dirty_threshold must be in (0, 1]")
        if self.batch_window_timeout_seconds <= 0:
            raise ConfigError("batch_window_timeout_seconds must be > 0")
        if self.batch_window_idle_seconds < 0:
            raise ConfigError("batch_window_idle_seconds must be >= 0")
        if self.batch_window_idle_seconds > self.batch_window_timeout_seconds:
            raise ConfigError("idle window cannot exceed timeout window")
        if self.pool_sharding and not self.incremental_planning:
            raise ConfigError("pool_sharding requires incremental_planning")
        if self.pool_parallelism not in ("serial", "thread"):
            raise ConfigError("pool_parallelism must be 'serial' or 'thread'")
        if self.pool_max_workers < 0:
            raise ConfigError("pool_max_workers must be >= 0")
        if self.pool_backend not in ("", "serial", "thread", "process"):
            raise ConfigError("pool_backend must be '', 'serial', 'thread', or 'process'")
        if self.pool_backend == "process" and not self.pool_sharding:
            raise ConfigError("pool_backend 'process' requires pool_sharding")
        if self.pool_cycle_timeout_seconds <= 0:
            raise ConfigError("pool_cycle_timeout_seconds must be > 0")
        if self.warm_state_save_interval_seconds < 0:
            raise ConfigError("warm_state_save_interval_seconds must be >= 0")
        if self.forecast_min_interval_seconds < 0:
            raise ConfigError("forecast_min_interval_seconds must be >= 0")
        if self.forecast_max_gangs < 1:
            raise ConfigError("forecast_max_gangs must be >= 1")
        if self.forecast_max_backfill_pairs < 0:
            raise ConfigError("forecast_max_backfill_pairs must be >= 0")
        if self.forecast_small_pod_chips < 1:
            raise ConfigError("forecast_small_pod_chips must be >= 1")
        if self.forecast_enabled:
            raise ConfigError(f"forecast_enabled: the forecaster's thread waits for {ITEM_18B}")
        if self.audit_sample_rate > 0:
            raise ConfigError(f"audit_sample_rate > 0: the auditor waits for {ITEM_18B}")

    @property
    def plan_backend(self) -> str:
        """The controller's pool backend: ``process``, else serial."""
        return "process" if self.pool_backend == "process" else ""


@dataclass
class OperatorConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    # the GB a plain nvidia.com/gpu counts in nos.nebuly.com/gpu-memory
    gpu_memory_gb: int = H100_MEMORY_GB

    def validate(self) -> None:
        if self.gpu_memory_gb < 1:
            raise ConfigError("gpu_memory_gb must be >= 1")


@dataclass
class AgentConfig:
    """The MIG and the MPS agent's (the reference's ``TpuAgentConfig``)."""

    manager: ManagerConfig = field(default_factory=ManagerConfig)
    report_config_interval_seconds: float = 10.0

    def validate(self) -> None:
        if self.report_config_interval_seconds <= 0:
            raise ConfigError("report_config_interval_seconds must be > 0")


@dataclass
class AutoscalerConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    # a fast-window burn above this adds a replica; scale-down needs both
    # windows below scale_down_burn_threshold, the spec's budget surplus,
    # and scale_down_stable_seconds since the last transition
    scale_up_burn_threshold: float = 1.0
    scale_down_burn_threshold: float = 0.5
    scale_down_stable_seconds: float = 120.0
    # a model counts as active (no scale to zero) this long after its
    # last arrival
    recent_activity_seconds: float = 30.0
    # the watch-driven reconcile's requeue, so idle timers fire with no
    # event (the polled reconciler runs every step instead)
    resync_seconds: float = 5.0

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
        if self.resync_seconds <= 0:
            raise ConfigError("resync_seconds must be > 0")


@dataclass
class SchedulerConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    retry_seconds: float = 0.5
    gang_wait_timeout_seconds: float = 30.0
    # pods opt in by naming this scheduler; empty: every pod
    scheduler_name: str = SCHEDULER_NAME

    def validate(self) -> None:
        if self.retry_seconds <= 0:
            raise ConfigError("retry_seconds must be > 0")
