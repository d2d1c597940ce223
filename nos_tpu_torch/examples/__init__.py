"""Runnable examples, the port's counterparts of ``examples/``:

    python -m nos_tpu_torch.examples.serve_llama  [--real-weights DIR]
    python -m nos_tpu_torch.examples.train_llama
    python -m nos_tpu_torch.examples.finetune_lora [--real-weights DIR]
    python -m nos_tpu_torch.examples.preempt_resume

Each ``main(argv=None)`` takes the reference's flags and ``--device``
(``cuda`` unless ``--device cpu``), takes the reference's steps and
returns the numbers it prints. One process runs with no mesh; under
``torchrun`` (or the control plane's gang coordinates) with an even
world size the examples lay the reference's ``("dp", "tp")`` mesh over
the ranks, tp 2 innermost.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def dp_tp_mesh(device: torch.device):
    """None in one process; else a ``("dp", "tp")`` mesh of (world / 2,
    2) over every rank, the process group started first from torchrun's
    env (``WORLD_SIZE`` > 1) or the gang coordinates
    (``parallel/distributed.py:initialize``) unless it already runs."""
    from nos_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        else:
            distributed.initialize(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return None
    if world % 2:
        raise ValueError(f"the examples' (dp, tp) mesh needs an even world size, not {world}")
    return distributed.global_mesh((world // 2, 2), ("dp", "tp"), device)


def is_main_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
