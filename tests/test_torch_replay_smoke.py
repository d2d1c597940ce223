"""``run --record`` then ``replay``, through the command line's own
entry points, as nos_tpu's ``tests/record/test_replay_smoke.py`` runs
its own: a short suite in H100 terms (one MIG node of 8 H100s, two
3g.40gb pods where the reference has one 2x4 board and two 4-chip pods,
and one MPS node with a 20gb pod), the auditor at rate 1, its log
written on exit; the replay exits 0 and prints "0 drift(s), 0 audit
violation(s)" and its host seconds. Then ``python -m nos_tpu_torch
replay`` refuses a missing file (2) and a perturbed log exits 1. A log
whose ring wrapped (a recorder of 8 records under more writes) is
refused with 2, "log wrapped at seq N".
"""
import json
import time

from nos_tpu_torch import __main__ as entry
from nos_tpu_torch.cmd.replay import main as replay_main
from nos_tpu_torch.cmd.run import main as run_main, seed_pod
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.record import FlightRecorder, load_jsonl
from nos_tpu_torch.timeline.sizes import SIZES

CONFIG = """
partitioner:
  batchWindowTimeoutSeconds: 1.0
  batchWindowIdleSeconds: 0.05
  auditSampleRate: 1.0
scheduler:
  retrySeconds: 0.2
agent:
  reportConfigIntervalSeconds: 0.2
manager:
  healthProbeHost: 127.0.0.1
nodes:
  - name: smoke-node
    gpus: 8
    partitioning: mig
  - name: smoke-mps
    gpus: 8
    partitioning: mps
pods:
  - name: smoke-w1
    mig: 3g.40gb
  - name: smoke-w2
    mig: 3g.40gb
  - name: smoke-s1
    mps: 20gb
"""


def test_record_then_replay_exits_zero(tmp_path, capsys):
    cfg = tmp_path / "smoke.yaml"
    cfg.write_text(CONFIG)
    record = tmp_path / "smoke-record.jsonl"
    start = time.monotonic()
    try:
        rc = run_main(["--config", str(cfg), "--record", str(record), "--run-seconds", "6",
                       "--health-port", "0"])
    finally:
        SIZES.unregister("record.flight_ring")
    assert rc == 0
    assert time.monotonic() - start < 60
    records = load_jsonl(str(record))
    kinds = {r["kind"] for r in records}
    assert {"scheduler.cycle", "planner.plan", "delta"} <= kinds, sorted(kinds)
    capsys.readouterr()

    assert entry.main(["replay", str(record)]) == 0
    out = capsys.readouterr().out
    assert "0 drift(s), 0 audit violation(s)" in out, out
    assert "replay took" in out

    assert replay_main([str(tmp_path / "missing.jsonl")]) == 2
    cycle = next(r for r in records if r["kind"] == "scheduler.cycle")
    cycle["decision"] = "fail" if cycle["decision"] != "fail" else "bind"
    cycle["node"], cycle["bound"] = "", []
    perturbed = tmp_path / "perturbed.jsonl"
    perturbed.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert replay_main([str(perturbed)]) == 1
    assert "DRIFT" in capsys.readouterr().out


def test_a_wrapped_log_is_refused(tmp_path, capsys):
    store = NodeStore()
    flight = FlightRecorder(capacity=8)
    SIZES.unregister("record.flight_ring")
    flight.attach(store)
    for i in range(12):
        store.create(seed_pod({"name": f"w-{i}", "mig": "1g.10gb"}))
    flight.detach()
    records = flight.records()
    assert len(records) == 8 and records[0]["seq"] == 6
    log = tmp_path / "wrapped.jsonl"
    flight.export_jsonl(str(log))
    capsys.readouterr()
    assert replay_main([str(log)]) == 2
    assert "log wrapped at seq 6" in capsys.readouterr().err
