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

What the port does not run is refused, never quietly ignored:
``forecast_enabled`` raises a ``ConfigError`` naming item 18b.3 (the
forecaster's thread), and ``ObservabilityConfig.node_top_k`` above 0 one
naming item 18b.3 (the capacity ledger's per-node gauges); their other
knobs are validated as the reference's. ``audit_sample_rate`` (in [0,
1], as the reference's) is the share of plans the invariant auditor
audits (``record/audit.py``; 0 builds none). ``pool_parallelism`` keeps the
reference's values; its ``thread`` mode plans serially (the port's
deliberate difference: the planner is pure Python, and threads plan no
faster). ``timeline_sample_seconds`` reads a component's
``manager.timelineSampleSeconds`` (5), which must be above 0: the
reference takes any number, and a sampler at 0 would spin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu_torch.api.v1alpha1.constants import SCHEDULER_NAME

# the H100's GB: what a plain nvidia.com/gpu counts as in quotas
H100_MEMORY_GB = 80
DEVICE_PLUGIN_CONFIG_MAP = "nos-device-plugin-config"
ITEM_18B3 = "item 18b.3 (the capacity ledger's rest and the forecaster's thread)"


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
    # the share of plans the invariant auditor audits (0: no auditor)
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
    # the forecaster's thread: item 18b.3; True is refused
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
            raise ConfigError(f"forecast_enabled: the forecaster's thread waits for {ITEM_18B3}")

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


def timeline_sample_seconds(manager: dict) -> float:
    """The health timeline's interval of a ``manager`` block."""
    seconds = float(manager.get("timelineSampleSeconds", 5.0))
    if seconds <= 0:
        raise ConfigError(f"timelineSampleSeconds must be > 0 (got {seconds})")
    return seconds


@dataclass
class ObservabilityConfig:
    """The observability plane's knobs (``nos_tpu/api/config/v1alpha1.py:
    202-250``): the governor's series budgets, the tail-kept trace
    retention and the debug pages. The defaults leave it all off."""

    # family → its most exact label sets (``observability.seriesBudget``)
    series_budget: Dict[str, int] = field(default_factory=dict)
    # the budget of every other family; None: unbudgeted
    series_budget_default: Optional[int] = None
    # the capacity ledger's per-node tiering: item 18b.3; above 0 is refused
    node_top_k: int = 0
    trace_tail_capacity: int = 64
    trace_boring_sample_n: int = 1
    # root span name → seconds past which its trace is slow
    trace_slow_thresholds: Dict[str, float] = field(default_factory=dict)
    debug_page_limit: int = 500

    def validate(self) -> None:
        for family, budget in self.series_budget.items():
            if budget <= 0:
                raise ConfigError(f"seriesBudget.{family} must be > 0 (got {budget})")
        if self.series_budget_default is not None and self.series_budget_default <= 0:
            raise ConfigError("seriesBudget default must be > 0 when set")
        if self.node_top_k < 0:
            raise ConfigError("node_top_k must be >= 0")
        if self.trace_tail_capacity < 0:
            raise ConfigError("trace_tail_capacity must be >= 0")
        if self.trace_boring_sample_n < 1:
            raise ConfigError("trace_boring_sample_n must be >= 1")
        for kind, threshold in self.trace_slow_thresholds.items():
            if threshold <= 0:
                raise ConfigError(f"trace_slow_thresholds.{kind} must be > 0 (got {threshold})")
        if self.debug_page_limit < 0:
            raise ConfigError("debug_page_limit must be >= 0")
        if self.node_top_k:
            raise ConfigError(f"node_top_k > 0: the per-node capacity gauges wait for "
                              f"{ITEM_18B3}")


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
