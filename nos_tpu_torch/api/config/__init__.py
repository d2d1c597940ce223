"""The components' configuration: counterpart of ``nos_tpu/api/config``,
trimmed to the autoscaler's."""
from nos_tpu_torch.api.config.v1alpha1 import AutoscalerConfig, ConfigError

__all__ = ["AutoscalerConfig", "ConfigError"]
