"""GPU sharing comparison: latency a client against clients sharing one GPU.

Counterpart of ``demos/tpu-sharing-comparison/harness.py`` (``run_worker``
``:38``, ``launch``, ``main``), on the axes of the reference nos demo
(demos/gpu-sharing-comparison): N real client processes share one GPU
under each discipline, released together by the reference's READY / GO
barrier, and each times its own inferences.

- ``time-sliced``: N plain CUDA processes on the whole card; the GPU
  time-slices their contexts.
- ``mps``: a private ``nvidia-cuda-mps-control -d`` (its own
  CUDA_MPS_PIPE_DIRECTORY and CUDA_MPS_LOG_DIRECTORY under a temp
  directory), each client held to the memory slice ``SharedGpu`` carves
  for N equal slices (CUDA_MPS_PINNED_DEVICE_MEM_LIMIT); the daemon is
  told to quit, and any of its processes still alive is killed, in a
  ``finally``.
- ``mig``: each client on its own MIG instance (CUDA_VISIBLE_DEVICES set
  to its UUID), N instances of the largest profile ``MigGpu`` can carve N
  of, created through NVML and destroyed in a ``finally``; only when MIG
  mode is already enabled. The harness never changes the MIG mode (that
  resets the GPU).

Each client is ``sharing_client``'s model: ResNet-50 (bf16, B 8, 224²,
channels_last, weights and images from seed 0) on the card, the tiny
config with ``--device cpu``. A row gives the mean and p50 latency a
client (the means and p50s of its clients, averaged, as the reference
averages means) and the aggregate images/s, beside the solo figures (the
time-sliced row at N 1, run first). Every client's first-batch logits are
held against the solo client's: same seed, so the same logits, within
LOGITS_REL_LIMIT of the largest solo logit (a MIG instance has fewer SMs,
and cuDNN may pick another algorithm for it, which rounds the bf16
accumulations otherwise). A worker that crashes, or logits that disagree,
raise. A condition of the machine (no CUDA device, MIG mode disabled, no
``nvidia-cuda-mps-control``, an MPS server that will not serve) makes the
row ``{"not_run": reason}``, never a pass.

    python3 -m nos_tpu_torch.demos.sharing [--device cpu] [--pods 1,3,5,7]
        [--seconds S] [--out BENCH_torch_sharing.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

from nos_tpu_torch.demos import sharing_client

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DISCIPLINES = ("time-sliced", "mps", "mig")
BATCH = 8
IMAGE = 224
LOGITS_REL_LIMIT = 2e-2
WORKER_TIMEOUT_S = 300
MPS_QUIT_GRACE_S = 15.0  # for the daemon to quit, then again for a kill to land


# ------------------------------------------------------------------ worker


def run_worker(device: str) -> None:
    """One client: build the model, save the first batch's logits to
    NOS_DEMO_LOGITS, print READY, wait for GO, run inferences for
    NOS_DEMO_SECONDS and print one JSON line of figures."""
    import torch

    infer, _ = sharing_client.build(device, BATCH, IMAGE)
    torch.save(infer().cpu(), os.environ["NOS_DEMO_LOGITS"])
    infer()  # a second call: first-use costs stay outside the window
    seconds = float(os.environ.get("NOS_DEMO_SECONDS", "5"))
    # compile and first-call times differ between workers; the parent
    # releases all of them only once every one is ready, so the windows
    # overlap
    print("READY", flush=True)
    sys.stdin.readline()
    latencies = []
    start = time.monotonic()
    stop_at = start + seconds
    while time.monotonic() < stop_at:
        latencies.append(sharing_client.timed(infer))
    report = sharing_client.summary(latencies, BATCH, time.monotonic() - start)
    report["device"] = torch.cuda.get_device_name() if device == "cuda" else device
    print(json.dumps(report), flush=True)


# ----------------------------------------------------------------- parent


def launch(n: int, seconds: float, device: str, out_dir: str, tag: str,
           env_for: Callable[[int], Dict[str, str]] = lambda i: {}) -> List[dict]:
    """Spawn ``n`` clients (``env_for(i)`` added to client i's
    environment), release them together once all are READY, and return
    their reports, each with the path of its first-batch logits."""
    procs = []
    paths = [os.path.join(out_dir, f"{tag}-{i}.pt") for i in range(n)]
    try:
        for i in range(n):
            env = {**os.environ, "NOS_DEMO_SECONDS": str(seconds),
                   "NOS_DEMO_LOGITS": paths[i],
                   "PYTHONPATH": os.pathsep.join(
                       filter(None, [REPO_ROOT, os.environ.get("PYTHONPATH")])),
                   **env_for(i)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "nos_tpu_torch.demos.sharing", "--worker",
                 "--device", device],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        for i, p in enumerate(procs):
            line = p.stdout.readline().decode().strip()
            if line != "READY":
                raise RuntimeError(
                    f"{tag}: worker {i} (pid {p.pid}) failed before READY "
                    f"(rc={p.poll()}): {line!r}; see its stderr above")
        for p in procs:
            p.stdin.write(b"GO\n")
            p.stdin.flush()
        reports = []
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=seconds + WORKER_TIMEOUT_S)
            lines = out.decode().strip().splitlines()
            if p.returncode != 0 or not lines:
                raise RuntimeError(
                    f"{tag}: worker {i} (pid {p.pid}) died rc={p.returncode} with no "
                    f"report; see its stderr above")
            reports.append({**json.loads(lines[-1]), "logits": paths[i]})
        return reports
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def aggregate(reports: List[dict]) -> dict:
    """One row's figures from its clients' reports: the mean of the
    clients' mean latencies (the reference's figure), of their p50s, and
    the images/s they served together."""
    means = [r["avg_s"] for r in reports if r["avg_s"] is not None]
    p50s = [r["p50_s"] for r in reports if r["p50_s"] is not None]
    return {"pods": len(reports),
            "mean_s": statistics.fmean(means) if means else float("nan"),
            "p50_s": statistics.fmean(p50s) if p50s else float("nan"),
            "images_per_s": sum(r["images_per_s"] for r in reports),
            "clients": [{k: r[k] for k in ("inferences", "avg_s", "p50_s", "images_per_s")}
                        for r in reports]}


def logits_rel_err(got_path: str, want_path: str) -> float:
    import torch

    got, want = torch.load(got_path), torch.load(want_path)
    return float((got - want).abs().max() / want.abs().max())


def hold_logits(row: dict, reports: List[dict], solo_logits: str) -> None:
    errs = [logits_rel_err(r["logits"], solo_logits) for r in reports]
    row["logits_max_rel_err"] = max(errs)
    row["logits_rel_limit"] = LOGITS_REL_LIMIT
    if not row["logits_max_rel_err"] <= LOGITS_REL_LIMIT:
        raise RuntimeError(
            f"{row['discipline']} x{row['pods']}: first-batch logits {errs} off the solo "
            f"client's by more than {LOGITS_REL_LIMIT} of its largest")


# ---------------------------------------------------------------- MPS


def mps_slice_gb(n: int, memory_gb: int) -> int:
    """The memory slice each of ``n`` MPS clients holds: SharedGpu's
    geometry for n equal slices of the GPU."""
    from nos_tpu_torch.gpu.slicing import SharedGpu, profile_gb

    gpu = SharedGpu(0, memory_gb)
    profile = f"{memory_gb // n}gb"
    gpu.update_geometry_for({profile: n})
    if gpu.free != {profile: n}:
        raise RuntimeError(f"SharedGpu carved {gpu.free} for {n} x {profile}")
    return profile_gb(profile)


_PROBE = """
import ctypes, sys
cuda = ctypes.CDLL("libcuda.so.1")
dev, ctx, name = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_char_p()
rc = cuda.cuInit(0) or cuda.cuDeviceGet(ctypes.byref(dev), 0) or \\
    cuda.cuCtxCreate_v2(ctypes.byref(ctx), 0, dev)
if rc == 0:
    cuda.cuCtxDestroy_v2(ctx)
else:
    cuda.cuGetErrorName(rc, ctypes.byref(name))
print(rc, (name.value or b"").decode())
"""


def _processes_with(env_value: str) -> List[int]:
    """pids whose environment holds ``env_value`` (the daemon's pipe
    directory marks the MPS processes this harness started). A zombie's
    environment reads empty: it holds nothing and is not counted."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if env_value.encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            continue
    return [p for p in pids if p != os.getpid()]


@dataclasses.dataclass
class MpsDaemon:
    """A private MPS control daemon: ``env`` holds the variables its
    clients need, or ``reason`` says why the machine will not run MPS;
    ``left`` lists, once it is shut down, the pids of its processes that
    outlived the shutdown (none, unless a kill failed)."""
    env: Optional[Dict[str, str]] = None
    reason: Optional[str] = None
    left: List[int] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def mps_daemon():
    """Starts a private MPS control daemon and yields its MpsDaemon. On
    exit quits it, kills any of its processes still alive and records
    the survivors in ``left``."""
    ctl = shutil.which("nvidia-cuda-mps-control")
    if ctl is None:
        yield MpsDaemon(reason="no nvidia-cuda-mps-control on PATH")
        return
    tmp = tempfile.mkdtemp(prefix="nos-mps-")
    env = {"CUDA_MPS_PIPE_DIRECTORY": os.path.join(tmp, "pipe"),
           "CUDA_MPS_LOG_DIRECTORY": os.path.join(tmp, "log")}
    for d in env.values():
        os.makedirs(d)
    full = {**os.environ, **env}
    daemon = MpsDaemon()
    try:
        start = subprocess.run([ctl, "-d"], env=full, timeout=30, capture_output=True,
                               text=True)
        if start.returncode != 0:
            daemon.reason = (f"nvidia-cuda-mps-control -d exited {start.returncode}: "
                             f"{start.stderr.strip()}")
        else:
            probe = subprocess.run([sys.executable, "-c", _PROBE], env=full, timeout=120,
                                   capture_output=True, text=True)
            rc, _, name = probe.stdout.strip().partition(" ")
            if probe.returncode != 0 or rc != "0":
                daemon.reason = (f"MPS server will not serve: a client's context creation "
                                 f"gave CUDA error {rc} {name}{_server_failure(env)}")
        if daemon.reason is None:
            daemon.env = env
        yield daemon
    finally:
        subprocess.run([ctl], input="quit\n", env=full, timeout=30, text=True,
                       capture_output=True)
        pipe = env["CUDA_MPS_PIPE_DIRECTORY"]
        if _wait_gone(pipe, MPS_QUIT_GRACE_S):
            for pid in _processes_with(pipe):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            daemon.left = _wait_gone(pipe, MPS_QUIT_GRACE_S)
        shutil.rmtree(tmp, ignore_errors=True)


def _wait_gone(env_value: str, seconds: float) -> List[int]:
    """Waits up to ``seconds`` for ``_processes_with(env_value)`` to empty;
    returns what is left."""
    deadline = time.monotonic() + seconds
    while (pids := _processes_with(env_value)) and time.monotonic() < deadline:
        time.sleep(0.2)
    return pids


def _server_failure(env) -> str:
    """The server log's last failure line, if any."""
    path = os.path.join(env["CUDA_MPS_LOG_DIRECTORY"], "server.log")
    try:
        with open(path) as f:
            failed = [line.strip() for line in f if "Failed" in line or "failed" in line]
    except OSError:
        return ""
    return f"; server.log: {failed[-1]}" if failed else ""


# ---------------------------------------------------------------- MIG


def mig_profile_for(n: int, used: Optional[Dict[str, int]] = None) -> Optional[str]:
    """The largest H100 MIG profile of which ``MigGpu`` carves ``n`` free
    instances beside the ``used`` ones; None if none."""
    from nos_tpu_torch.gpu.known import H100_80GB, KNOWN_GPUS
    from nos_tpu_torch.gpu.mig import MigGpu

    profiles = sorted(KNOWN_GPUS[H100_80GB].profiles,
                      key=lambda p: (p.memory_slices, p.compute_slices), reverse=True)
    for p in profiles:
        gpu = MigGpu(0, H100_80GB, used=used)
        gpu.update_geometry_for({p.name: n})
        if gpu.free.get(p.name, 0) >= n:
            return p.name
    return None


@contextlib.contextmanager
def mig_instances(client, n: int):
    """``n`` MIG devices of ``mig_profile_for(n)`` created on GPU 0
    through ``client`` (a MigDeviceClient); yields them and destroys
    exactly those in a ``finally``."""
    existing = {}
    for d in client.get_mig_devices():
        if d.gpu_index == 0:
            existing[d.profile] = existing.get(d.profile, 0) + 1
    profile = mig_profile_for(n, used=existing)
    if profile is None:
        raise RuntimeError(f"no MIG profile carves {n} instances beside {existing}")
    devices = client.create_mig_devices(0, {profile: n})
    try:
        yield devices
    finally:
        for d in devices:
            client.delete_mig_device(d.uuid)


def mig_state(device: str) -> tuple:
    """(client, None) on a GPU in MIG mode, (None, reason) otherwise."""
    if device != "cuda":
        return None, f"MIG needs a GPU (--device {device})"
    from nos_tpu_torch.device.nvml import NVML_DEVICE_MIG_ENABLE, Nvml, NvmlMigClient

    nvml = Nvml()  # raises where there is no NVML: never a quiet skip
    current, pending = nvml.mig_mode(0)
    if current != NVML_DEVICE_MIG_ENABLE:
        nvml.close()
        return None, f"MIG mode disabled (NVML: current {current}, pending {pending})"
    return NvmlMigClient(nvml), None


# --------------------------------------------------------------- sweep


def run_sweep(device: str, pods, seconds: float, log: Callable[[dict], None]) -> dict:
    """Every discipline at every pod count; the solo run (time-sliced at
    N 1) first. Returns {"solo", "rows", "mps_left", ...}; ``log`` gets
    each row. ``mps_left`` lists the MPS processes of this sweep that
    outlived its daemon's shutdown."""
    from nos_tpu_torch.gpu.known import H100_80GB, memory_gb_per_gpu

    out_dir = tempfile.mkdtemp(prefix="nos-sharing-")
    t0 = time.time()
    try:
        solo_reports = launch(1, seconds, device, out_dir, "solo")
        solo = {"discipline": "time-sliced", **aggregate(solo_reports)}
        solo_logits = solo_reports[0]["logits"]
        rows = []

        def row(discipline, n, env_for=lambda i: {}, **extra):
            if discipline == "time-sliced" and n == 1:
                r = dict(solo)
            else:
                reports = launch(n, seconds, device, out_dir, f"{discipline}-{n}", env_for)
                r = {"discipline": discipline, **aggregate(reports)}
                hold_logits(r, reports, solo_logits)
            r.update(extra, solo_mean_s=solo["mean_s"], solo_p50_s=solo["p50_s"],
                     solo_images_per_s=solo["images_per_s"])
            rows.append(r)
            log(r)

        def not_run(discipline, reason):
            for n in pods:
                r = {"discipline": discipline, "pods": n, "not_run": reason}
                rows.append(r)
                log(r)

        for n in pods:
            row("time-sliced", n)
        mps_left: List[int] = []
        if device != "cuda":
            not_run("mps", f"MPS needs a GPU (--device {device})")
        else:
            with mps_daemon() as daemon:
                if daemon.reason:
                    not_run("mps", daemon.reason)
                else:
                    for n in pods:
                        gb = mps_slice_gb(n, memory_gb_per_gpu(H100_80GB))
                        limit = {**daemon.env, "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT": f"0={gb}G"}
                        row("mps", n, lambda i: limit, mps_slice_gb=gb)
            mps_left = daemon.left
        client, reason = mig_state(device)
        if reason:
            not_run("mig", reason)
        else:
            try:
                for n in pods:
                    with mig_instances(client, n) as devices:
                        row("mig", n, lambda i: {"CUDA_VISIBLE_DEVICES": devices[i].uuid},
                            mig_profile=devices[0].profile,
                            mig_uuids=[d.uuid for d in devices])
            finally:
                client.nvml.close()
        return {"device": device, "pods": list(pods), "seconds": seconds,
                "batch": BATCH, "image": IMAGE,
                "model": "resnet50 bf16 channels_last" if device == "cuda"
                else "tiny_resnet_config", "solo": solo, "rows": rows,
                "mps_left": mps_left, "sweep_s": time.time() - t0}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def table(result: dict) -> str:
    """The reference's results table: mean latency a client, seconds."""
    pods = result["pods"]
    lines = ["| discipline | " + " | ".join(f"{n} pods" for n in pods) + " |",
             "|---" * (len(pods) + 1) + "|"]
    for discipline in DISCIPLINES:
        cells = []
        for n in pods:
            r = next((r for r in result["rows"]
                      if r["discipline"] == discipline and r["pods"] == n), None)
            cells.append("" if r is None else
                         "not run" if "not_run" in r else f"{r['mean_s']:.4f}")
        lines.append(f"| {discipline} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--pods", default="1,3,5,7")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", default=None, help="write the sweep's JSON here")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        run_worker(args.device)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("sharing: no CUDA device; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    pods = [int(x) for x in args.pods.split(",")]
    result = run_sweep(args.device, pods, args.seconds,
                       log=lambda r: print(json.dumps(r), file=sys.stderr, flush=True))
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        result["card"] = card
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(table(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
