"""The components' configurations: counterpart of ``nos_tpu/api/config``."""
from nos_tpu_torch.api.config.v1alpha1 import (
    AgentConfig,
    AutoscalerConfig,
    ConfigError,
    GpuPartitionerConfig,
    ManagerConfig,
    ObservabilityConfig,
    OperatorConfig,
    SchedulerConfig,
)

__all__ = ["AgentConfig", "AutoscalerConfig", "ConfigError", "GpuPartitionerConfig",
           "ManagerConfig", "ObservabilityConfig", "OperatorConfig", "SchedulerConfig"]
