"""Serving: the continuous-batching ``Engine`` (bf16, int8 or int4
weights, the int8 KV cache, multi-tenant LoRA), ``SpecEngine``, their
telemetry, and tensor- and expert-parallel serving (``Engine(mesh=...)``
and ``SpecEngine(mesh=...)`` over the shards of ``shard_for_serving``,
with the head-sharded KV cache of ``kv_cache_sharding``).

Under a mesh, ``kv_quant`` raises ``ValueError``, as in the reference,
and multi-LoRA serving ``NotImplementedError`` (the reference has no
sharding rule for adapter nodes).
"""
from nos_tpu_torch.serve.engine import Completion, Engine, GenRequest  # noqa: F401
from nos_tpu_torch.serve.sharded import kv_cache_sharding, shard_for_serving  # noqa: F401
from nos_tpu_torch.serve.spec_engine import SpecEngine  # noqa: F401
from nos_tpu_torch.serve.telemetry import (  # noqa: F401
    RequestRecord,
    ServeClock,
    ServeTelemetry,
    VirtualServeClock,
)
