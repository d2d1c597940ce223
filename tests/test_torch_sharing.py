"""The GPU sharing comparison (nos_tpu_torch.demos) on the CPU, against
demos/tpu-sharing-comparison/harness.py.

The harness runs real worker processes here: two tiny-ResNet clients
time-sliced for a second, beside a solo client, each row in the schema
the card's run writes; MPS and MIG rows say why they did not run. The
aggregation (the mean of the clients' mean latencies) is held exactly
against the JAX harness's ``launch`` fed the same worker reports through
a fake ``Popen``; the barrier's failure paths run on the same fake. The
MIG row's instances come from MigGpu's geometry and are created and
destroyed through the simulator; the MPS slices from SharedGpu's.
"""
import contextlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nos_tpu_torch.demos import sharing
from nos_tpu_torch.device.sim import SimMigClient, SimMigPool

ROOT = Path(__file__).resolve().parents[1]


def _reference_harness():
    spec = importlib.util.spec_from_file_location(
        "tpu_sharing_harness", ROOT / "demos" / "tpu-sharing-comparison" / "harness.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _FakeWorker:
    """A worker process that says READY and then prints ``report``
    (or dies before READY when ``report`` is None)."""

    def __init__(self, report, returncode=0):
        self.pid = 4242
        self.returncode = None
        self._rc = returncode
        self.stdin = io.BytesIO()
        self.stdout = io.BytesIO(b"READY\n" if report is not None else b"")
        self._out = (json.dumps(report) + "\n").encode() if report is not None else b""
        self.killed = False

    def poll(self):
        return self.returncode

    def communicate(self, timeout=None):
        self.returncode = self._rc
        return self._out, b""

    def kill(self):
        self.killed = True
        self.returncode = -9

    def wait(self):
        return self.returncode


def _fake_popen(reports, made):
    it = iter(reports)

    def popen(*args, **kwargs):
        worker = _FakeWorker(*next(it))
        made.append(worker)
        return worker

    return popen


@pytest.mark.parametrize("means", [[0.004], [0.01, 0.02, 0.03], [0.5, None, 0.25, 0.125]])
def test_aggregation_matches_the_reference_harness(monkeypatch, tmp_path, means):
    harness = _reference_harness()
    made = []
    monkeypatch.setattr(harness.subprocess, "Popen", _fake_popen(
        [({"n": 0 if m is None else 10, "mean_s": m},) for m in means], made))
    want = harness.launch(len(means), 1.0, None)

    reports = [{"inferences": 0 if m is None else 10, "avg_s": m, "p50_s": m,
                "images_per_s": 0.0 if m is None else 80.0} for m in means]
    monkeypatch.setattr(sharing.subprocess, "Popen", _fake_popen(
        [(r,) for r in reports], made))
    got = sharing.launch(len(means), 1.0, "cpu", str(tmp_path), "t")
    row = sharing.aggregate(got)
    assert row["mean_s"] == want
    assert row["pods"] == len(means)
    assert row["images_per_s"] == 80.0 * sum(m is not None for m in means)
    assert [c["avg_s"] for c in row["clients"]] == means
    assert [r["logits"] for r in got] == [str(tmp_path / f"t-{i}.pt") for i in range(len(means))]


def test_a_worker_dying_before_ready_raises_and_the_others_are_killed(monkeypatch, tmp_path):
    made = []
    monkeypatch.setattr(sharing.subprocess, "Popen", _fake_popen(
        [({"avg_s": 1.0},), (None,), ({"avg_s": 1.0},)], made))
    with pytest.raises(RuntimeError, match="worker 1 .* failed before READY"):
        sharing.launch(3, 1.0, "cpu", str(tmp_path), "t")
    assert [w.killed for w in made] == [True, True, True]


def test_a_worker_crashing_after_go_raises(monkeypatch, tmp_path):
    made = []
    monkeypatch.setattr(sharing.subprocess, "Popen", _fake_popen(
        [({"avg_s": 1.0},), ({"avg_s": 1.0}, 1)], made))
    with pytest.raises(RuntimeError, match="worker 1 .* died rc=1"):
        sharing.launch(2, 1.0, "cpu", str(tmp_path), "t")


def test_logits_off_the_solo_clients_raise(tmp_path):
    want = torch.tensor([[1.0, -2.0, 4.0]])
    torch.save(want, tmp_path / "solo.pt")
    torch.save(want + 0.0625, tmp_path / "near.pt")  # exact in f32
    torch.save(want + 0.5, tmp_path / "far.pt")
    row = {"discipline": "time-sliced", "pods": 2}
    sharing.hold_logits(row, [{"logits": str(tmp_path / "near.pt")}], str(tmp_path / "solo.pt"))
    assert row["logits_max_rel_err"] == 0.0625 / 4
    with pytest.raises(RuntimeError, match="first-batch logits"):
        sharing.hold_logits(row, [{"logits": str(tmp_path / "far.pt")}],
                            str(tmp_path / "solo.pt"))


# ------------------------------------------------------------ real workers


def test_two_tiny_resnet_clients_time_sliced_on_the_cpu():
    logged = []
    result = sharing.run_sweep("cpu", pods=(2,), seconds=1.0, log=logged.append)
    assert result["model"] == "tiny_resnet_config" and result["batch"] == 8
    solo = result["solo"]
    assert solo["pods"] == 1 and solo["clients"][0]["inferences"] > 0
    rows = {(r["discipline"], r["pods"]): r for r in result["rows"]}
    assert rows.keys() == {("time-sliced", 2), ("mps", 2), ("mig", 2)}
    assert logged == result["rows"]
    assert result["mps_left"] == []
    row = rows[("time-sliced", 2)]
    assert set(row) == {"discipline", "pods", "mean_s", "p50_s", "images_per_s", "clients",
                        "logits_max_rel_err", "logits_rel_limit", "solo_mean_s",
                        "solo_p50_s", "solo_images_per_s"}
    assert len(row["clients"]) == 2 and all(c["inferences"] > 0 for c in row["clients"])
    # same seed, same machine: the same logits
    assert row["logits_max_rel_err"] == 0.0
    assert row["mean_s"] == pytest.approx(sum(c["avg_s"] for c in row["clients"]) / 2)
    assert row["images_per_s"] == pytest.approx(sum(c["images_per_s"] for c in row["clients"]))
    assert row["solo_mean_s"] == solo["mean_s"]
    assert rows[("mps", 2)]["not_run"] == "MPS needs a GPU (--device cpu)"
    assert rows[("mig", 2)]["not_run"] == "MIG needs a GPU (--device cpu)"
    assert "not run" in sharing.table(result)


def test_the_cli_writes_the_sweep(tmp_path):
    out = tmp_path / "sharing.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "nos_tpu_torch.demos.sharing", "--device", "cpu", "--pods", "1",
         "--seconds", "0.5", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(out.read_text())
    assert result["pods"] == [1] and result["rows"][0]["discipline"] == "time-sliced"
    assert proc.stdout.splitlines()[0].startswith("| discipline | 1 pods |")


def test_the_client_prints_a_window(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), REPORT_WINDOW_SECONDS="0.3")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nos_tpu_torch.demos.sharing_client", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert line["device"] == "cpu" and line["inferences"] > 0
    assert line["p50_s"] > 0 and line["images_per_s"] > 0


# ---------------------------------------------------------------- MIG, MPS


@pytest.mark.parametrize("n,used,profile", [
    (1, None, "7g.80gb"), (2, None, "3g.40gb"), (3, None, "2g.20gb"),
    (4, None, "1g.20gb"), (5, None, "1g.10gb"), (7, None, "1g.10gb"), (8, None, None),
    (1, {"3g.40gb": 1}, "4g.40gb"), (2, {"3g.40gb": 1}, "2g.20gb"),
])
def test_the_mig_rows_profile_comes_from_mig_gpu(n, used, profile):
    assert sharing.mig_profile_for(n, used=used) == profile


def test_the_mig_rows_instances_are_created_and_destroyed():
    pool = SimMigPool()
    client = SimMigClient(pool, "local")
    pool.create("local", 0, "3g.40gb", 1)  # an instance someone else made
    with pytest.raises(RuntimeError, match="boom"):
        with sharing.mig_instances(client, 3) as devices:
            assert [d.profile for d in devices] == ["1g.10gb"] * 3  # beside a 3g.40gb
            assert len({d.uuid for d in devices}) == 3
            raise RuntimeError("boom")
    assert pool.geometry("local") == {0: {"3g.40gb": 1}}


def test_mps_slices_come_from_shared_gpu():
    assert [sharing.mps_slice_gb(n, 80) for n in (1, 3, 5, 7)] == [80, 26, 16, 11]


def test_mps_without_its_control_daemon_is_not_run(monkeypatch):
    monkeypatch.setattr(sharing.shutil, "which", lambda name: None)
    with sharing.mps_daemon() as daemon:
        assert daemon.env is None and daemon.reason == "no nvidia-cuda-mps-control on PATH"
    assert daemon.left == []


# A control daemon that leaves a process behind in its environment and
# ignores "quit", as a hung MPS server would
_STUBBORN_CTL = """#!/bin/sh
if [ "$1" = "-d" ]; then
  sleep 120 >/dev/null 2>&1 &
  echo $! > {pid_file}
  exit 0
fi
cat >/dev/null
"""


def _alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


@pytest.mark.parametrize("kill_lands", [True, False])
def test_mps_processes_that_outlive_quit_are_killed_or_reported(
        tmp_path, monkeypatch, kill_lands):
    pid_file = tmp_path / "stubborn.pid"
    ctl = tmp_path / "nvidia-cuda-mps-control"
    ctl.write_text(_STUBBORN_CTL.format(pid_file=pid_file))
    ctl.chmod(0o755)
    monkeypatch.setattr(sharing.shutil, "which", lambda name: str(ctl))
    monkeypatch.setattr(sharing, "MPS_QUIT_GRACE_S", 0.5)
    real_kill = os.kill
    if not kill_lands:
        monkeypatch.setattr(sharing.os, "kill", lambda pid, sig: None)
    try:
        with sharing.mps_daemon() as daemon:
            # no CUDA driver here, so the probe's client fails
            assert daemon.env is None
            assert daemon.reason.startswith("MPS server will not serve")
        pid = int(pid_file.read_text())
        assert daemon.left == ([] if kill_lands else [pid])
        assert _alive(pid) is not kill_lands
    finally:
        monkeypatch.undo()
        if pid_file.exists():
            with contextlib.suppress(ProcessLookupError):
                real_kill(int(pid_file.read_text()), signal.SIGKILL)
