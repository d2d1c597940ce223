"""Multi-process runtime bootstrap for ``torch.distributed``.

Counterpart of ``nos_tpu/parallel/distributed.py``: the control plane's
multi-host gang expander stamps each gang member with its coordinates,

  NOS_TPU_COORDINATOR    host:port of process 0 (the gang leader)
  NOS_TPU_NUM_PROCESSES  gang size
  NOS_TPU_PROCESS_ID     this member's rank

and the training container calls ``initialize()`` before it touches a
device. After that ``global_mesh`` lays the ``dp`` / ``sp`` / ``tp``
axes over every rank (``init_device_mesh``). The env names and the
default port are the reference's, kept here as the port's own copy.

Backends: ``nccl`` when each rank has a card of its own, ``gloo`` on the
CPU or when the caller names it. Ranks that share one card must use
gloo: NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nos_tpu_torch import _resolve_device

logger = logging.getLogger("nos_tpu_torch.distributed")

COORDINATOR_ENV = "NOS_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "NOS_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "NOS_TPU_PROCESS_ID"
DEFAULT_COORDINATOR_PORT = 8476


def gang_member_env(leader: str, namespace: str, rank: int, size: int,
                    port: int = DEFAULT_COORDINATOR_PORT) -> dict:
    """The env block the expander stamps on gang member ``rank``: the
    coordinator is the leader pod's stable DNS name under a headless
    service named after the gang."""
    return {
        COORDINATOR_ENV: f"{leader}.{leader}.{namespace}.svc:{port}",
        NUM_PROCESSES_ENV: str(size),
        PROCESS_ID_ENV: str(rank),
    }


def env_coordinates(environ=None) -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_processes, process_id) from the env, or None when
    the gang coordinates are absent or incomplete."""
    environ = environ if environ is not None else os.environ
    coordinator = environ.get(COORDINATOR_ENV, "")
    try:
        num = int(environ.get(NUM_PROCESSES_ENV, ""))
        pid = int(environ.get(PROCESS_ID_ENV, ""))
    except ValueError:
        return None
    if not coordinator or num < 1 or not (0 <= pid < num):
        return None
    return coordinator, num, pid


def initialize(environ=None, backend: Optional[str] = None, device=None) -> bool:
    """``torch.distributed.init_process_group`` from the gang coordinates
    (``tcp://<coordinator>``).

    ``backend`` defaults to ``nccl`` on ``cuda`` (each rank selects card
    ``rank mod device_count``) and ``gloo`` on the CPU. Returns True when
    a multi-process group was initialised, False for the single-process
    case (absent or size-1 coordinates), so callers can call it first
    thing in main() unconditionally."""
    coords = env_coordinates(environ)
    if coords is None or coords[1] == 1:
        logger.info("distributed: single-process (no gang coordinates)")
        return False
    coordinator, num, pid = coords
    dev = _resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num, rank=pid)
    logger.info("distributed: initialized as process %d/%d (%s, coordinator %s)",
                pid, num, backend, coordinator)
    return True


def global_mesh(axis_shape: Sequence[int], axis_names: Sequence[str], device=None):
    """A ``DeviceMesh`` over every process (call after ``initialize``)."""
    from nos_tpu_torch.parallel.mesh import mesh_from_devices

    return mesh_from_devices(tuple(axis_shape), tuple(axis_names), device)
