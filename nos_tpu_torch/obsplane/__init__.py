"""The observability plane at fleet size: counterpart of ``nos_tpu/obsplane/``.

- ``governor``: an ``ObservabilityConfig``'s series budgets, and the
  cardinality report (the budget itself is enforced in
  ``util/metrics.py``'s admission, off the hot path's imports).
- ``streaming``: the cursor paging and JSONL lines of ``/debug/traces``
  and ``/debug/timeline``.
- ``apply``: an ``ObservabilityConfig`` onto the process-wide registry and
  tracer, with a revert; imported where it is called.
"""
from nos_tpu_torch.obsplane import governor, streaming  # noqa: F401

__all__ = ["governor", "streaming"]
