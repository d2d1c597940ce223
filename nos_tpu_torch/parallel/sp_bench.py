"""Time train steps over a ``dp`` x ``sp`` mesh of ranks that share one card.

    python3 -m nos_tpu_torch.parallel.sp_bench [--mesh 2x2] [--layers 6]
        [--tokens 2x4096] [--steps 3]

Spawns dp·sp ranks on cuda:0 in one gloo group (NCCL refuses two ranks
on one device, so the collectives stage device tensors through pinned
host memory) after building the kernels in the parent. Llama-3-8B at
full width and ``--layers`` deep, random weights from a seed, flash
attention on the ring; without remat, then with it, ``--steps``
momentum-SGD steps in a row on one state, each timed on the host
clock, with the gradient sum over the mesh timed apart from the rest of
the step. With dp > 1 the params are FSDP shards: the dp sum of a 2-D
leaf's gradient is the reduce-scatter inside the backward, so the sum
timed apart is the sp sum of those leaves and the norms' sum. The first
step of a setting carries the process's one-time costs; the later ones
are its steady state. Rank 0 prints one JSON line
per step, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import shutil
import subprocess
import tempfile
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def timed_grad_sum():
    """Within the block, each gradient sum over the mesh that
    ``make_train_step`` runs is timed on the host clock, the card
    synchronized on both sides; yields the list its ms are appended to."""
    import torch

    from nos_tpu_torch.parallel import train as pt

    sum_over_mesh, times = pt._sum_over_mesh, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sum_over_mesh(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    pt._sum_over_mesh = timed
    try:
        yield times
    finally:
        pt._sum_over_mesh = sum_over_mesh


def _rank(rank, world, work, args, card) -> None:
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=args.layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, args.tokens, generator=gen, device="cuda")
    mesh = pm.mesh_from_devices(args.mesh, ("dp", "sp"))
    block = llama_data_sharding(mesh, tokens).contiguous()
    try:
        for remat in (False, True):
            step, shard = make_train_step(mesh, dataclasses.replace(cfg, remat=remat),
                                          learning_rate=1e-3)
            state = shard(llama.init_llama_params(cfg, seed=41, device="cuda"), donate=True)
            for i in range(args.steps):
                dist.barrier()
                torch.cuda.synchronize()
                with timed_grad_sum() as sum_ms:
                    t0 = time.perf_counter()
                    state, loss = step(state, block)
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                if rank == 0:
                    print(json.dumps({
                        "bench": "sp_train_step", "mesh": dict(zip(("dp", "sp"), args.mesh)),
                        "layers": args.layers, "tokens": list(args.tokens),
                        "remat": remat, "step": i, "loss": float(loss),
                        "step_ms_gloo_host_staged": wall,
                        "grad_sum_ms_gloo_host_staged": sum(sum_ms),
                        "step_without_grad_sum_ms": wall - sum(sum_ms),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "card": card}), flush=True)
            del state
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _dims(text: str) -> tuple:
    return tuple(int(x) for x in text.split("x"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh", type=_dims, default=(2, 2), help="dp x sp, e.g. 2x2")
    parser.add_argument("--layers", type=int, default=6)
    parser.add_argument("--tokens", type=_dims, default=(2, 4096), help="B x S, global")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()

    import torch.multiprocessing as mp

    from nos_tpu_torch.ops import _build

    _build.build(_build.KERNELS)  # ranks load the kernels, never build them
    work = tempfile.mkdtemp(prefix="nos-sp-bench-")
    try:
        mp.spawn(_rank, args=(args.mesh[0] * args.mesh[1], work, args, card_line()),
                 nprocs=args.mesh[0] * args.mesh[1])
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
