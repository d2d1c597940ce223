"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain ``extern "C"`` launcher (no PyTorch headers: seconds, not minutes)
and is loaded with ``ctypes``. Libraries land in ``nos_tpu_torch/_build/``
under a name keyed by a hash of the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header rebuilds and an unchanged
one loads at once. ptxas's report (registers, spills) lands beside each
library as ``lib<name>-<hash>.log``. A failed build raises; nothing falls
back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
# Every kernel source of the port (csrc/<name>.cu).
KERNELS = ("flash_fwd", "flash_bwd")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds from the start of build() to each named library's nvcc exit,
# for the builds that build() ran (a cached library is not timed).
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built: keyed by
    the source, every ``csrc/*.cuh`` it may include, and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc
    processes started together; returns name -> library path. Raises
    with the compiler's output if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    start = time.monotonic()
    running = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as sink:
            proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT)
        running[name] = (out, tmp, log, proc)
    failures = []
    while running:
        for name in [n for n, (*_, proc) in running.items() if proc.poll() is not None]:
            out, tmp, log, proc = running.pop(name)
            BUILD_SECONDS[name] = time.monotonic() - start
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{log.read_text()}")
                log.unlink()
                continue
            os.replace(log, BUILD_DIR / f"{out.stem}.log")
            os.replace(tmp, out)  # atomic: a reader never sees half a library
        time.sleep(0.02)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel entry in ``csrc/<name>.cu``,
    read from the ptxas log beside its built library: mangled entry name
    -> {"registers", "spill_stores", "spill_loads"}."""
    return parse_ptxas_log((BUILD_DIR / f"{library_path(name).stem}.log").read_text())


def parse_ptxas_log(log: str) -> Dict[str, Dict[str, int]]:
    """The per-entry figures of an ``nvcc -Xptxas -v`` log."""
    report: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            report[entry] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[entry]["spill_stores"] = int(m.group(1))
            report[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[entry]["registers"] = int(m.group(1))
    return report
