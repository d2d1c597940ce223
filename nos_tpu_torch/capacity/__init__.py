"""The capacity ledger's accounting core: counterpart of
``nos_tpu/capacity`` (GB-seconds of GPU memory, polled)."""
from nos_tpu_torch.capacity.ledger import (
    BUCKET_AUTOSCALER,
    BUCKET_NO_DEMAND,
    BUCKET_PENDING,
    BUCKET_RECONFIG,
    BUCKET_RESERVED,
    IDLE_BUCKETS,
    CapacityLedger,
    dominant_unserved_reason,
    state_from_store,
)

__all__ = ["BUCKET_AUTOSCALER", "BUCKET_NO_DEMAND", "BUCKET_PENDING", "BUCKET_RECONFIG",
           "BUCKET_RESERVED", "IDLE_BUCKETS", "CapacityLedger", "dominant_unserved_reason",
           "state_from_store"]
