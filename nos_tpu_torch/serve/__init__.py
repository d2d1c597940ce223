from nos_tpu_torch.serve.engine import Completion, Engine, GenRequest  # noqa: F401
from nos_tpu_torch.serve.spec_engine import SpecEngine  # noqa: F401
from nos_tpu_torch.serve.telemetry import (  # noqa: F401
    RequestRecord,
    ServeClock,
    ServeTelemetry,
    VirtualServeClock,
)
