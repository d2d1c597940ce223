"""The flight recorder, the invariant auditor and offline replay.

Counterpart of ``nos_tpu/record/``: the control plane's decisions (bind
this pod, carve that node, flip that quota label) flow through layered
incremental state (the snapshots kept by delta, the verdict cache, the
lacking totals, the futility memo) whose silent drift would corrupt
decisions without failing a test. This package closes that loop:

- ``FlightRecorder`` (``recorder.py``): every store write of the kinds
  decisions read, and one record a control cycle (scheduler cycle, plan,
  quota reconcile, actuation, ledger observation, forecast, timeline
  finding), in a bounded ring with JSONL export, served at
  ``/debug/record``;
- ``ReplaySession`` (``replay.py``): rebuilds the cluster from the
  recorded writes and re-runs each decision on the state it saw,
  reporting drift (``python -m nos_tpu_torch replay``);
- ``InvariantAuditor`` (``audit.py``): named checks that recompute each
  incremental structure's ground truth and compare (sampled live,
  exhaustive in replay).

The package imports no torch.
"""
from nos_tpu_torch.record.audit import AuditViolation, InvariantAuditor, build_auditor
from nos_tpu_torch.record.recorder import FlightRecorder, load_jsonl
from nos_tpu_torch.record.replay import ReplayReport, ReplaySession, drift_exit_code

__all__ = [
    "AuditViolation",
    "FlightRecorder",
    "InvariantAuditor",
    "ReplayReport",
    "ReplaySession",
    "build_auditor",
    "drift_exit_code",
    "load_jsonl",
]
