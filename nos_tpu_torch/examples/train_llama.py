"""End-to-end Llama training: the port of ``examples/train_llama.py``.

    python -m nos_tpu_torch.examples.train_llama [--device cpu]
    torchrun --nproc-per-node 4 -m nos_tpu_torch.examples.train_llama

The reference's recipe step for step: a deterministic ``BatchLoader``
with device prefetch, ``make_train_step`` with AdamW (3e-3, weight decay
0.01) behind global-norm clipping at 1.0 (the reference's
``optax.chain(clip_by_global_norm(1.0), adamw(...))``), a checkpoint
every 10 steps and a resume from the latest one when ``--ckpt-dir``
already holds a run. One process trains with no mesh; under torchrun
with an even world size the ranks form the reference's ``("dp", "tp")``
mesh (FSDP over dp, Megatron over tp).

On the card the model is small but runs as the reference runs on chips,
with ``attention="flash"`` and per-layer remat, so each step launches
the forward kernel twice a layer (the recompute) and the two backward
kernels once. ``tiny_config``'s head_dim is 8, which the card's kernels
do not take (they take 64, 128 or 256), so on the card the config is
``card_config()``: ``tiny_config`` at d_model 512 over its 8 heads
(head_dim 64) and d_ff 1024. On the CPU it is ``tiny_config`` with
dense attention and no remat, as the reference's CPU default.

The clip lives in the optimizer (``ClippedAdamW``): it scales the
gradients as ``optax.clip_by_global_norm`` does, then steps AdamW.
Under a mesh a rank holds shards, so the global norm sums each leaf's
squares over the axes its spec shards it on (tp, FSDP's dp) and counts
a replicated leaf once (``global_grad_norm``); ``clip_grad_norm_`` over
a rank's shards would compute another norm.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.examples import dp_tp_mesh, is_main_rank
from nos_tpu_torch.models.llama import init_llama_params, tiny_config

STEPS = 30
CHECKPOINT_EVERY = 10
MAX_NORM, LEARNING_RATE, WEIGHT_DECAY = 1.0, 3e-3, 0.01


def card_config():
    """The example's model on the card: head_dim 64, flash + remat."""
    return tiny_config(d_model=512, d_ff=1024, attention="flash", remat=True)


def global_grad_norm(grads, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm of the whole gradient, f32, on every rank: each
    leaf's sum of squares reduced over the mesh axes its spec names (a
    shard's part of a sharded leaf), a replicated leaf's counted once."""
    from nos_tpu_torch.parallel.comm import all_reduce
    from nos_tpu_torch.parallel.mesh import mesh_groups

    partial = {}
    for i, g in enumerate(grads):
        axes = () if mesh is None else tuple(a for a in specs[i] if a is not None)
        sq = g.detach().float().square().sum()
        partial[axes] = sq if axes not in partial else partial[axes] + sq
    total = None
    for axes, sq in partial.items():
        if axes:
            sq = all_reduce(sq, mesh_groups(mesh, axes), kind="clip")
        total = sq if total is None else total + sq
    return total.sqrt()


class ClippedAdamW(torch.optim.AdamW):
    """AdamW behind global-norm clipping: ``optax.chain(
    clip_by_global_norm(max_norm), adamw(lr, weight_decay=...))``. Each
    gradient becomes ``g`` when the global norm is below ``max_norm`` and
    ``g / norm * max_norm`` otherwise (optax's form, no host sync), then
    AdamW steps. ``mesh`` / ``specs``: the rank's shards and their
    degraded specs in ``tree_leaves`` order. ``last_norm`` holds the
    norm of the latest step (a device scalar)."""

    def __init__(self, params, mesh=None, specs=None, max_norm: float = MAX_NORM,
                 **adamw) -> None:
        super().__init__(params, **adamw)
        self.mesh, self.specs, self.max_norm = mesh, specs, max_norm
        self.last_norm = None

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]]
        norm = global_grad_norm(grads, self.mesh, self.specs)
        for g in grads:
            wide = g.float()
            g.copy_(torch.where(norm < self.max_norm, wide, wide / norm * self.max_norm))
        self.last_norm = norm
        return super().step(closure)


def build(config, params, mesh=None, device=None, max_norm: float = MAX_NORM,
          **adamw):
    """(train_step, state): ``make_train_step`` with ``ClippedAdamW``
    (lr 3e-3, weight decay 0.01 unless ``adamw`` says otherwise) over
    ``params`` (whole; donated), sharded on ``mesh``."""
    from nos_tpu_torch.parallel.sharding import param_rules, rule_leaves
    from nos_tpu_torch.parallel.train import make_train_step

    adamw = dict(dict(lr=LEARNING_RATE, weight_decay=WEIGHT_DECAY), **adamw)
    specs = None if mesh is None else rule_leaves(param_rules(params, mesh, config))

    def factory(leaves):
        return ClippedAdamW(leaves, mesh=mesh, specs=specs, max_norm=max_norm, **adamw)

    train_step, shard_state = make_train_step(mesh, config, optimizer=factory, device=device)
    return train_step, shard_state(params, donate=True)


def _shared_dir(path: str) -> str:
    """``path``, or a fresh temporary directory made by rank 0 and named
    to every rank."""
    if path:
        return path
    made = [tempfile.mkdtemp(prefix="nos-tpu-torch-train-") if is_main_rank() else None]
    if dist.is_initialized():
        dist.broadcast_object_list(made, src=0)
    return made[0]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--checkpoint-every", type=int, default=CHECKPOINT_EVERY)
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint directory; a run there resumes (default: a new one)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.parallel.checkpoint import Checkpointer

    args = parser().parse_args(argv)
    device = _resolve_device(args.device)
    mesh = dp_tp_mesh(device)
    on_card = device.type == "cuda"
    config = card_config() if on_card else tiny_config(attention="dense", remat=False)
    world = dist.get_world_size() if dist.is_initialized() else 1
    say = print if is_main_rank() else (lambda *a, **k: None)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None} "
        f"over {world} process(es) on {device.type}")

    train_step, state = build(config, init_llama_params(config, seed=0, device=device),
                              mesh, device)
    corpus = np.random.default_rng(0).integers(
        0, config.vocab_size, size=1_000_000).astype(np.int32)
    loader = BatchLoader(corpus, batch=16, seq_len=64, seed=0, mesh=mesh)
    ckpt_dir = _shared_dir(args.ckpt_dir)
    losses, norms = {}, {}
    with Checkpointer(ckpt_dir, mesh=mesh) as ckpt:
        start = ckpt.latest_step() or 0
        if start:
            state, start = ckpt.restore(state)
            loader.skip(start)
            say(f"resumed from step {start}")
        stream = prefetch_to_device(iter(loader), device, mesh=mesh)
        with contextlib.closing(stream):
            for step, batch in zip(range(start + 1, args.steps + 1), stream):
                state, loss = train_step(state, batch)
                losses[step], norms[step] = loss, state[1].last_norm
                if step % 5 == 0:
                    say(f"step {step:3d}  loss {float(loss):.4f}")
                if step % args.checkpoint_every == 0:
                    ckpt.save(step, state, force=True)
        ckpt.wait()
    say(f"done; checkpoints in {ckpt_dir}")
    return {
        "mesh": None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "config": {"d_model": config.d_model, "n_layers": config.n_layers,
                   "head_dim": config.head_dim, "attention": config.attention,
                   "remat": config.remat},
        "start_step": start,
        "losses": {k: float(v) for k, v in losses.items()},
        "grad_norms": {k: float(v) for k, v in norms.items()},
        "ckpt_dir": ckpt_dir,
        "latest_checkpoint": ckpt.latest_step(),
    }


if __name__ == "__main__":
    main()
