"""The rank side of the port's multi-rank CPU tests.

The test files (``tests/test_torch_ring_attention.py``,
``test_torch_ulysses.py``, ``test_torch_distributed.py``,
``test_torch_sp_train.py``) compute the reference's results in the
parent process, JAX on the conftest's virtual CPU devices, and spawn
ranks that run the functions below. Each rank joins a gloo group through
a file under the test's ``tmp_path`` (``file://`` init: no port for
pytest-xdist workers to collide on), runs the port on its block and
writes its results as ``.npz`` files that the parent compares.

This module imports no JAX: every spawned rank imports it afresh.
"""
from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, nprocs: int, tmp_path, *args, init: bool = True) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes, each in one
    gloo group (``init``) or left to start its own; a rank's exception
    fails the call."""
    rendezvous = f"file://{os.path.join(str(tmp_path), 'rendezvous')}"
    mp.spawn(_entry, args=(nprocs, rendezvous if init else None, fn, args),
             nprocs=nprocs)


def _entry(rank, nprocs, rendezvous, fn, args):
    torch.set_num_threads(1)
    if rendezvous is not None:
        dist.init_process_group("gloo", init_method=rendezvous, rank=rank,
                                world_size=nprocs)
    try:
        fn(rank, *args)
        # no rank tears its group down while another still talks to it
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def save(directory, name: str, rank: int, /, **arrays) -> None:
    np.savez(os.path.join(str(directory), f"{name}_r{rank}.npz"), **arrays)


def load(out, name: str, rank: int) -> dict:
    with np.load(os.path.join(str(out), f"{name}_r{rank}.npz")) as f:
        return dict(f)


def assemble(out, name: str, key: str, dp: int, sp: int) -> np.ndarray:
    """The global array [B, S, ...] from every rank's [B/dp, S/sp, ...]
    block of ``key`` (rank d·sp + s holds block (d, s))."""
    rows = []
    for d in range(dp):
        rows.append(np.concatenate(
            [load(out, name, d * sp + s)[key] for s in range(sp)], axis=1))
    return np.concatenate(rows, axis=0)


def cpu_mesh(dims, names=("dp", "sp")):
    from nos_tpu_torch.parallel.mesh import mesh_from_devices

    return mesh_from_devices(dims, names, device="cpu")


def block(mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's [B/dp, S/sp, ...] block of a global array."""
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    return llama_data_sharding(mesh, torch.from_numpy(np.ascontiguousarray(x))).clone()


def _attention_fn(kind: str):
    from nos_tpu_torch.parallel import ring_attention as ra
    from nos_tpu_torch.parallel import ulysses

    return {
        "ring_flash": ra.ring_flash_attention,
        "ring": ra.ring_attention,
        "ulysses_flash": functools.partial(ulysses.ulysses_attention, attention="flash"),
        "ulysses": ulysses.ulysses_attention,
    }[kind]


def attention(rank, out, dims, arrays, cases) -> None:
    """Each case ``(name, kind, causal, window)`` on this rank's blocks of
    ``arrays`` (q, k, v, do): the output and its q / k / v gradients."""
    mesh = cpu_mesh(dims)
    q, k, v, do = (block(mesh, arrays[key]) for key in ("q", "k", "v", "do"))
    for name, kind, causal, window in cases:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = _attention_fn(kind)(*leaves, mesh, causal=causal, window=window)
        grads = torch.autograd.grad(got, leaves, do.reshape(got.shape))
        save(out, name, rank, out=got.detach().numpy(),
             **{g: t.numpy() for g, t in zip(("dq", "dk", "dv"), grads)})


def attention_contracts(rank, out) -> None:
    """The SP entry points' raises, on real meshes; a rank writes the
    message of each case's error (or "no error")."""
    from nos_tpu_torch.parallel import ring_attention as ra
    from nos_tpu_torch.parallel import ulysses

    sp4 = cpu_mesh((4,), ("sp",))
    dp4 = cpu_mesh((4,), ("dp",))
    sp_tp = cpu_mesh((2, 2), ("sp", "tp"))

    def qkv(hq, hkv, s=16, hd=8):
        gen = torch.Generator().manual_seed(0)
        return (torch.randn(1, s, hq, hd, generator=gen),
                torch.randn(1, s, hkv, hd, generator=gen),
                torch.randn(1, s, hkv, hd, generator=gen))

    cases = {
        "ulysses_indivisible_heads": lambda: ulysses.ulysses_attention(*qkv(2, 1), sp4),
        "ulysses_kv_heads_below_sp": lambda: ulysses.ulysses_attention(*qkv(8, 2), sp4),
        "ulysses_no_sp_axis": lambda: ulysses.ulysses_attention(*qkv(4, 4), dp4),
        "ring_no_sp_axis": lambda: ra.ring_attention(*qkv(4, 4), dp4),
        "ring_flash_no_sp_axis": lambda: ra.ring_flash_attention(*qkv(4, 4), dp4),
        "ring_flash_gqa": lambda: ra.ring_flash_attention(*qkv(3, 2), sp4),
        "ring_tp": lambda: ra.ring_flash_attention(*qkv(4, 4), sp_tp),
        "ulysses_tp": lambda: ulysses.ulysses_attention(*qkv(4, 4), sp_tp),
    }
    for fn in (ulysses.ulysses_attention, ra.ring_attention, ra.ring_flash_attention):
        cases[f"{fn.__name__}_window_noncausal"] = functools.partial(
            fn, *qkv(4, 4), sp4, causal=False, window=4)
        cases[f"{fn.__name__}_window_zero"] = functools.partial(fn, *qkv(4, 4), sp4, window=0)
    errors = {}
    for name, fn in cases.items():
        try:
            fn()
            errors[name] = "no error"
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    save(out, "contracts", rank, **{k: np.array(v) for k, v in errors.items()})


# ------------------------------------------------------------------ model


def port_model(params_np, overrides):
    """(config, params) of the port's tiny f32 config from the reference's
    numpy params tree."""
    from nos_tpu_torch.bridge import params_from_numpy
    from nos_tpu_torch.models import llama

    cfg = llama.tiny_config(dtype=torch.float32, **overrides)
    return cfg, params_from_numpy(params_np, cfg, device="cpu")


def mesh_loss_grads(params, tokens, cfg, mesh):
    """``llama_loss`` of the rank's shards of ``params`` (whole) on its
    block of ``tokens`` (global, numpy), and the whole gradient: the
    ranks' shares summed as the trainer sums them, gathered. Every rank
    of the mesh calls it."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel.sharding import gather_params, rule_leaves, shard_params, \
        tree_rules
    from nos_tpu_torch.parallel.train import sum_gradients

    shards = shard_params(params, mesh, cfg)
    leaves = [p.requires_grad_(True) for p in llama.tree_leaves(shards)]
    loss = llama.llama_loss(shards, block(mesh, tokens), cfg, mesh)
    specs = rule_leaves(tree_rules(shards, mesh))
    grads = iter(sum_gradients(torch.autograd.grad(loss, leaves), leaves, mesh, specs))
    whole = gather_params(llama.tree_map(lambda _: next(grads), shards), mesh, cfg)
    return loss.detach(), llama.tree_leaves(whole)


def model_loss(rank, out, mesh, params_np, tokens, cases) -> None:
    """Each case ``(name, overrides)``: ``llama_loss`` on this rank's token
    block and shards and its gradient summed over the mesh, beside the
    one-device loss and gradient of the whole batch (rank 0)."""
    from nos_tpu_torch.models import llama

    for name, overrides in cases:
        cfg, params = port_model(params_np, overrides)
        loss, grads = mesh_loss_grads(params, tokens, cfg, mesh)
        arrays = {"loss": loss.numpy()}
        if rank == 0:
            leaves = [p.requires_grad_(True) for p in llama.tree_leaves(params)]
            one = llama.llama_loss(params, torch.from_numpy(tokens), cfg)
            arrays["one_loss"] = one.detach().numpy()
            for i, (g, w) in enumerate(zip(grads, torch.autograd.grad(one, leaves))):
                arrays[f"g{i}"] = g.numpy()
                arrays[f"one{i}"] = w.numpy()
        save(out, name, rank, **arrays)


def train(rank, out, mesh, name, params_np, overrides, batches, step_kwargs,
          adamw=None) -> None:
    """``make_train_step`` over the mesh on this rank's blocks of
    ``batches``: the losses, then the params (and the velocity of the
    built-in SGD) after the last step, gathered whole from the ranks'
    shards, in ``tree_leaves`` order. ``adamw``: torch.optim.AdamW's
    keyword arguments for the factory."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step
    from nos_tpu_torch.parallel.sharding import gather_params

    cfg, params = port_model(params_np, overrides)
    kwargs = dict(step_kwargs)
    if adamw is not None:
        kwargs["optimizer"] = functools.partial(torch.optim.AdamW, **adamw)
    step, shard = make_train_step(mesh, cfg, device="cpu", **kwargs)
    state = shard(params)
    losses = []
    for tokens in batches:
        state, loss = step(state, block(mesh, tokens))
        losses.append(float(loss))
    arrays = {"losses": np.array(losses)}
    whole = gather_params(llama.tree_map(lambda p: p.detach(), state[0]), mesh, cfg)
    for i, p in enumerate(llama.tree_leaves(whole)):
        arrays[f"p{i}"] = p.numpy()
    if adamw is None:
        for i, v in enumerate(llama.tree_leaves(gather_params(state[1], mesh, cfg))):
            arrays[f"v{i}"] = v.numpy()
    save(out, name, rank, **arrays)


def sp_model(rank, out, dims, params_np, tokens, loss_cases, runs) -> None:
    """``model_loss`` over ``loss_cases``, then ``train`` for each run
    ``(name, overrides, batches, step_kwargs, adamw)``, on one mesh."""
    mesh = cpu_mesh(dims)
    model_loss(rank, out, mesh, params_np, tokens, loss_cases)
    for name, overrides, batches, step_kwargs, adamw in runs:
        train(rank, out, mesh, name, params_np, overrides, batches, step_kwargs, adamw)


# ------------------------------------------------------------ distributed


def comm_ops(rank, out) -> None:
    """The collectives on a (2, 2) ('dp', 'sp') mesh of host tensors."""
    from nos_tpu_torch.parallel import comm
    from nos_tpu_torch.parallel.mesh import mesh_groups

    mesh = cpu_mesh((2, 2))
    sp = mesh.get_group("sp")
    coded = [torch.full((3, 5), float(rank)), torch.arange(7).to(torch.bfloat16) + rank,
             torch.full((2, 2), 10 * rank, dtype=torch.int64)]
    fwd = comm.ring_shift(coded, sp)
    back = comm.ring_shift(coded, sp, step=-1)
    # a [B, S, H, hd] block whose values name (rank, s, h)
    s_idx = torch.arange(4).view(1, 4, 1, 1)
    h_idx = torch.arange(4).view(1, 1, 4, 1)
    x = (100 * rank + 10 * s_idx + h_idx + torch.zeros(1, 4, 4, 2)).float()
    gathered = comm.all_to_all(x, sp, split_axis=2, concat_axis=1)
    restored = comm.all_to_all(gathered, sp, split_axis=1, concat_axis=2)
    # autograd: the backward of a shift is the reverse shift, of an
    # all-to-all the inverse exchange
    leaf = torch.full((2,), float(rank), requires_grad=True)
    (shifted,) = comm.RingShift.apply(sp, 1, leaf)
    (shifted * (rank + 1)).sum().backward()
    xa = x.clone().requires_grad_(True)
    (comm.AllToAll.apply(xa, sp, 2, 1) * torch.arange(8.0).view(1, 8, 1, 1)).sum().backward()
    one = torch.tensor([float(rank + 1)])
    save(out, "comm", rank,
         fwd0=fwd[0].numpy(), fwd1=fwd[1].float().numpy(), fwd2=fwd[2].numpy(),
         back0=back[0].numpy(), gathered=gathered.numpy(), restored=restored.numpy(),
         x=x.numpy(), shift_grad=leaf.grad.numpy(), a2a_grad=xa.grad.numpy(),
         sum_mesh=comm.all_reduce(one, mesh_groups(mesh)).numpy(),
         mean_mesh=comm.all_reduce(one, mesh_groups(mesh), mean=True).numpy(),
         sum_sp=comm.all_reduce(one, [sp]).numpy(), one_after=one.numpy(),
         transport=np.array(comm.transport(sp, "cpu")))


def mesh_builders(rank, out) -> None:
    from nos_tpu_torch.parallel import distributed, mesh as pm

    default = pm.default_training_mesh(device="cpu")
    glob = distributed.global_mesh((1, 4), ("dp", "sp"), device="cpu")
    slices = {"slice_2x2": pm.mesh_for_slice("2x2", device="cpu"),
              "slice_1x4": pm.mesh_for_slice("1x4", device="cpu"),
              "slice_2x2_dp4": pm.mesh_for_slice("2x2", dp=4, device="cpu")}
    errors = {}
    for key, fn in {
        "too_big": lambda: pm.mesh_from_devices((8,), ("sp",), device="cpu"),
        "slice_dp3": lambda: pm.mesh_for_slice("2x2", dp=3, device="cpu"),
        "slice_bad": lambda: pm.mesh_for_slice("2xq", device="cpu"),
    }.items():
        try:
            fn()
            errors[key] = "no error"
        except (ValueError, NotImplementedError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    save(out, "mesh", rank, default_names=np.array(default.mesh_dim_names),
         default_shape=np.array(default.shape),
         coords=np.array([pm.axis_index(default, a) for a in pm.TRAINING_AXES]),
         sizes=np.array([pm.axis_size(default, a) for a in pm.TRAINING_AXES]),
         global_sp=np.array(pm.axis_index(glob, "sp")),
         absent=np.array([pm.axis_index(glob, "tp"), pm.axis_size(glob, "tp")]),
         **{f"{k}_names": np.array(m.mesh_dim_names) for k, m in slices.items()},
         **{f"{k}_shape": np.array(m.shape) for k, m in slices.items()},
         **{k: np.array(v) for k, v in errors.items()})


def initialize_from_env(rank, out, environ) -> None:
    """``initialize`` from gang coordinates, then a collective over the
    group it made."""
    from nos_tpu_torch.parallel import distributed

    env = dict(environ, **{distributed.PROCESS_ID_ENV: str(rank)})
    started = distributed.initialize(env, device="cpu")
    total = torch.tensor([float(rank)])
    dist.all_reduce(total)
    mesh = distributed.global_mesh((1, dist.get_world_size()), ("dp", "sp"), device="cpu")
    save(out, "init", rank, started=np.array(started), rank=np.array(dist.get_rank()),
         world=np.array(dist.get_world_size()), backend=np.array(dist.get_backend()),
         total=total.numpy(), sp_index=np.array(mesh.get_local_rank("sp")))


def loader_blocks(rank, out, corpus) -> None:
    """BatchLoader under a (2, 2) mesh and prefetch_to_device's blocks."""
    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.data.pipeline import _process_grid
    from nos_tpu_torch.parallel.mesh import axis_index

    mesh = cpu_mesh((2, 2))
    rows = list(zip(range(2), BatchLoader(corpus, batch=4, seq_len=16, seed=5, mesh=mesh)))
    stream = prefetch_to_device(
        iter(BatchLoader(corpus, batch=4, seq_len=16, seed=5, mesh=mesh)),
        device="cpu", mesh=mesh)
    blocks = [next(stream).numpy() for _ in range(2)]
    stream.close()
    # the released feeder must end before the rank's process does
    for thread in threading.enumerate():
        if thread.name == "data-prefetch":
            thread.join(30)
            assert not thread.is_alive(), "the prefetch feeder outlived close()"
    save(out, "loader", rank, rows=np.stack([r for _, r in rows]), blocks=np.stack(blocks),
         dp=np.array(axis_index(mesh, "dp")), sp=np.array(axis_index(mesh, "sp")),
         grid_mesh=np.array(_process_grid(mesh)), grid_world=np.array(_process_grid()))


def out_of_slice(rank, out, params_np) -> None:
    """The multi-device paths that once raised, run on real meshes (each
    on the rank's shards), and what still raises: a rank writes each
    case's error text (or "no error")."""
    from nos_tpu_torch.models import llama, lora, moe
    from nos_tpu_torch.parallel import make_train_step, sharding
    from nos_tpu_torch.serve import Engine, SpecEngine, shard_for_serving

    dp_tp = cpu_mesh((2, 2), ("dp", "tp"))
    ep = cpu_mesh((4,), ("ep",))
    dp_sp = cpu_mesh((2, 2))
    odd = cpu_mesh((4,), ("xp",))
    cfg, params = port_model(params_np, {})
    moe_cfg = llama.tiny_config(dtype=torch.float32, n_experts=4)
    moe_params = llama.init_llama_params(moe_cfg, 0, device="cpu")
    lc = lora.LoraConfig()
    adapters = lora.init_lora_params(cfg, lc, 0, device="cpu")
    adapted = lora.attach_lora(params, adapters, lc)
    toks = torch.zeros((1, 4), dtype=torch.long)

    def moe_shards(mesh):
        return sharding.shard_params(moe_params, mesh, moe_cfg)

    cases = {
        "forward_ep": lambda: llama.llama_forward(params, toks, cfg, ep),
        "forward_not_a_mesh": lambda: llama.llama_forward(params, toks, cfg, object()),
        "forward_unknown_axis": lambda: llama.llama_forward(params, toks, cfg, odd),
        "forward_moe": lambda: llama.llama_forward(moe_shards(dp_sp), toks, moe_cfg, dp_sp),
        "forward_moe_tp": lambda: llama.llama_forward(moe_shards(dp_tp), toks, moe_cfg, dp_tp),
        "train_moe": lambda: make_train_step(dp_sp, moe_cfg, device="cpu"),
        "moe_mlp": lambda: moe.moe_mlp(moe_shards(dp_sp)["layers"][0]["moe"],
                                       torch.zeros(1, 2, 64), moe_cfg.moe_config(), dp_sp),
        "spec_engine": lambda: SpecEngine(shard_for_serving(params, dp_tp, cfg), cfg,
                                          params, cfg, mesh=dp_tp),
        "lora": lambda: lora.make_lora_train_step(dp_sp, cfg, lora.LoraConfig(),
                                                  device="cpu"),
        "lora_shards": lambda: sharding.shard_params(adapted, dp_tp, cfg),
        "engine_multi_lora": lambda: Engine(
            lora.stack_lora_adapters(shard_for_serving(params, dp_tp, cfg), [adapters], lc,
                                     rows=4), cfg, mesh=dp_tp),
        "engine_kv_quant": lambda: Engine(params, cfg, mesh=dp_tp, kv_quant=True),
        "param_sharding_moe": lambda: sharding.llama_param_sharding(dp_tp, moe_cfg),
        "quantized_sharding_moe": lambda: sharding.llama_quantized_sharding(dp_tp, moe_cfg),
        "shard_moe": lambda: sharding.shard_params(moe_params, dp_tp, moe_cfg),
    }
    errors = {}
    for key, fn in cases.items():
        try:
            fn()
            errors[key] = "no error"
        except (TypeError, ValueError, NotImplementedError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    save(out, "out_of_slice", rank, **{k: np.array(v) for k, v in errors.items()})
