"""The rank side of the port's expert-parallel, pipeline, LoRA-mesh and
SpecEngine-mesh CPU tests.

The test files (``tests/test_torch_ep.py``, ``test_torch_pipeline.py``,
``test_torch_mesh_lora_spec.py``) compute the reference's results in
the parent process, JAX on the conftest's virtual CPU devices over a
mesh of the same shape, and spawn gloo ranks
(``tests/torch_sp_ranks.py:spawn``) that run the functions below on the
rank's shards and write ``.npz`` results. Whole tensors are gathered
from the shards before they are written.

This module imports no JAX: every spawned rank imports it afresh.
"""
from __future__ import annotations

import numpy as np
import torch

from tests.torch_sp_ranks import block, cpu_mesh, mesh_loss_grads, port_model, save


def _moe_shards(params, mesh):
    from nos_tpu_torch.parallel.sharding import _degraded, moe_leaf_rule, take_shard

    return {k: take_shard(v, _degraded(moe_leaf_rule(k, v), mesh), mesh)
            for k, v in params.items()}


def ep_mesh(rank, out, dims, names, moe_np, x, mask, params_np, tokens, factors) -> None:
    """At each capacity factor: ``moe_mlp`` over the mesh on this rank's
    block of ``x`` (and of ``mask``) with the rank's expert shards, its
    kept-pair mask and aux; then a tiny MoE model's ``llama_forward``
    logits of the rank's token block and aux, ``llama_loss`` and its
    whole gradient (the ranks' shares summed as the trainer sums them,
    gathered)."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import moe as tm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding, shard_params

    mesh = cpu_mesh(dims, names)
    moe_p = {k: torch.from_numpy(v) for k, v in moe_np.items()}
    xb = llama_data_sharding(mesh, torch.from_numpy(x)).contiguous()
    mb = llama_data_sharding(mesh, torch.from_numpy(mask)).contiguous()
    for f in factors:
        mc = tm.MoeConfig(d_model=x.shape[-1], d_ff=moe_np["w_gate"].shape[-1],
                          n_experts=moe_np["router"].shape[1], top_k=2,
                          capacity_factor=f, dtype=torch.float32)
        shards = _moe_shards(moe_p, mesh)
        with torch.no_grad():
            got, aux = tm.moe_mlp(shards, xb, mc, mesh, return_aux=True, token_mask=mb)
            keep = tm._route(xb.reshape(-1, xb.shape[-1]), shards["router"], mc,
                             mb.reshape(-1), mesh, xb.shape[0])[4]
        cfg, params = port_model(params_np, dict(n_kv_heads=4, n_experts=4,
                                                 moe_capacity_factor=f))
        with torch.no_grad():
            logits, m_aux = llama.llama_forward(shard_params(params, mesh, cfg),
                                                block(mesh, tokens), cfg, mesh, with_aux=True)
        loss, grads = mesh_loss_grads(params, tokens, cfg, mesh)
        save(out, f"f{f}", rank, moe=got.numpy(), keep=keep.numpy(), aux=aux.numpy(),
             logits=logits.numpy(), model_aux=m_aux.numpy(), loss=loss.numpy(),
             **{f"g{i}": g.numpy() for i, g in enumerate(grads)})


def ep_train(rank, out, dims, names, params_np, overrides, batches, ckpt) -> None:
    """``make_train_step`` (momentum SGD) over the mesh from the bridged
    params: the losses, the params and velocity gathered whole after the
    last step, the rank's expert-stack shapes; then the state saved and
    restored onto one device (rank 0), its leaves written beside the
    gathered ones."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import checkpoint as ck
    from nos_tpu_torch.parallel import make_train_step
    from nos_tpu_torch.parallel.sharding import gather_params

    mesh = cpu_mesh(dims, names)
    cfg, params = port_model(params_np, overrides)
    step, shard = make_train_step(mesh, cfg, device="cpu", learning_rate=0.1)
    state = shard(params)
    losses = []
    for tokens in batches:
        state, loss = step(state, block(mesh, tokens))
        losses.append(float(loss))
    arrays = {"losses": np.array(losses),
              "stack_shape": np.array(state[0]["layers"][0]["moe"]["w_gate"].shape),
              "router_shape": np.array(state[0]["layers"][0]["moe"]["router"].shape)}
    trees = [gather_params(llama.tree_map(lambda p: p.detach(), state[0]), mesh, cfg),
             gather_params(state[1], mesh, cfg)]
    saved = [t.clone().numpy() for tree in trees for t in llama.tree_leaves(tree)]
    for i, x in enumerate(saved):
        arrays[f"w{i}"] = x
    ck.save_checkpoint(ckpt, state, 3, mesh=mesh)
    if rank == 0:
        _, shard_1 = make_train_step(None, cfg, device="cpu", learning_rate=0.1)
        blank = shard_1(llama.tree_map(torch.zeros_like, params))
        single, step_1 = ck.restore_checkpoint(ckpt, blank)
        ones = [t.detach().numpy() for tree in single for t in llama.tree_leaves(tree)]
        arrays["restored_step"] = np.array(step_1)
        arrays["bit_identical"] = np.array(all(
            a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
            for a, b in zip(saved, ones)) and len(saved) == len(ones))
    save(out, "train", rank, **arrays)


def _tokens_array(rows) -> np.ndarray:
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def ep_serve(rank, out, params_np, overrides, prompt, pad_id, prompts, budgets,
             meshes) -> None:
    """Over each ``(mesh id, names)`` of ``meshes`` (2 x 2 meshes of the
    same four ranks; a serving replica runs on the mesh's ``('tp',
    'ep')`` plane, replicated over dp): greedy ``generate()`` on a
    left-padded batch, and an Engine (two slots, so rows finish and ride
    while others run) over the rank's ``shard_for_serving`` shards, dense
    and with int8 stacks."""
    from nos_tpu_torch.models import generate as tg
    from nos_tpu_torch.models import quantize
    from nos_tpu_torch.serve import Engine, GenRequest, shard_for_serving
    from nos_tpu_torch.serve.sharded import serving_mesh

    cfg, params = port_model(params_np, overrides)
    for mesh_id, names in meshes:
        mesh = serving_mesh(cpu_mesh((2, 2), names))
        arrays = {}
        for fmt in ("f32", "int8"):
            tree = params if fmt == "f32" else quantize.quantize_params(params)
            shards = shard_for_serving(tree, mesh, cfg)
            if fmt == "f32":
                arrays["generate"] = tg.generate(shards, torch.from_numpy(prompt), cfg, 6,
                                                 pad_id=pad_id, mesh=mesh).numpy()
            eng = Engine(shards, cfg, max_slots=2, max_len=64, ticks_per_sync=4,
                         prefill_chunk=16, mesh=mesh)
            ids = [eng.submit(GenRequest(prompt=list(p), max_new_tokens=n))
                   for p, n in zip(prompts, budgets)]
            got = eng.run()
            arrays[f"engine_{fmt}"] = _tokens_array([got[i] for i in ids])
            stack = shards["layers"][0]["moe"]["w_gate"]
            arrays[f"stack_shape_{fmt}"] = np.array(
                (stack if fmt == "f32" else stack.q).shape)
        save(out, mesh_id, rank, **arrays)


# ----------------------------------------------------------------- pipeline


def pp_mesh(rank, out, dims, names, cases) -> None:
    """Each case ``(name, params_np, overrides, tokens, n_microbatches,
    grads)``: ``pipeline_llama_forward``'s logits of this rank's rows and,
    with ``grads``, ``pipeline_llama_loss`` and its whole gradient
    gathered to the stacked tree; then the raises of indivisible layers
    and batches."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import pipeline as pl

    mesh = cpu_mesh(dims, names)
    for name, params_np, overrides, tokens, m, grads in cases:
        cfg, params = port_model(params_np, overrides)
        stacked = pl.stack_layer_params(params)
        shards = pl.shard_pipeline_params(stacked, mesh, cfg)
        mine = pl.pipeline_data_sharding(mesh, torch.from_numpy(tokens), m)
        arrays = {"rows": mine.numpy()}
        with torch.no_grad():
            arrays["logits"] = pl.pipeline_llama_forward(shards, mine, cfg, mesh, m).numpy()
        if grads:
            loss, g = pl.pipeline_loss_and_grads(shards, mine, cfg, mesh, m)
            it = iter(g)
            whole = pl.gather_pipeline_params(llama.tree_map(lambda _: next(it), shards),
                                              mesh, cfg)
            arrays["loss"] = loss.numpy()
            for i, t in enumerate(llama.tree_leaves(whole)):
                arrays[f"g{i}"] = t.numpy()
            arrays["layers_held"] = np.array(shards["layers"]["wq"].shape[0])
        save(out, name, rank, **arrays)
    errors = {}
    cfg3, params3 = port_model(cases[0][1], dict(n_layers=3))
    for key, fn in {
        "layers": lambda: pl.shard_pipeline_params(pl.stack_layer_params(params3), mesh, cfg3),
        "batch": lambda: pl.pipeline_data_sharding(mesh, torch.zeros((5, 4), dtype=torch.long),
                                                   2),
        "sp_axis": lambda: pl.pipeline_llama_forward(
            shards, mine, cfg, cpu_mesh(dims, ("sp",) + tuple(names[1:]))),
        "llama_forward_pp": lambda: llama.llama_forward(params, torch.from_numpy(tokens),
                                                        cfg, mesh),
    }.items():
        try:
            fn()
            errors[key] = "no error"
        except (ValueError, TypeError, NotImplementedError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    save(out, "errors", rank, **{k: np.array(v) for k, v in errors.items()})


# ---------------------------------------------- LoRA and SpecEngine on a mesh


def lora_spec_mesh(rank, out, params_np, adapters_np, rank_r, batches, draft_np, prompts,
                   budgets, k) -> None:
    """On a ``('dp', 'tp')`` 2 x 2 mesh: ``make_lora_train_step`` over
    the rank's base shards and token blocks, three Adam steps, the losses
    and the adapters after each step; then a ``SpecEngine`` whose target
    is the rank's ``shard_for_serving`` shards (it serves on its tp line)
    and whose draft is whole, the completions."""
    from nos_tpu_torch.bridge import lora_from_numpy
    from nos_tpu_torch.models import lora
    from nos_tpu_torch.parallel.sharding import shard_params
    from nos_tpu_torch.serve import GenRequest, SpecEngine, shard_for_serving

    mesh = cpu_mesh((2, 2), ("dp", "tp"))
    cfg, params = port_model(params_np, dict(n_kv_heads=4))
    lc = lora.LoraConfig(rank=rank_r, targets=("wq", "wv", "wo", "w_up"))
    step, shard_adapters = lora.make_lora_train_step(mesh, cfg, lc, learning_rate=1e-2,
                                                     device="cpu")
    state = shard_adapters(lora_from_numpy(adapters_np, device="cpu"))
    base = shard_params(params, mesh, cfg)
    arrays = {}
    for n, tokens in enumerate(batches):
        state, loss = step(state, base, block(mesh, tokens))
        arrays[f"loss{n}"] = loss.numpy()
        for i, layer in enumerate(state[0]["layers"]):
            for t, ab in layer.items():
                for key, x in ab.items():
                    arrays[f"s{n}_{i}_{t}_{key}"] = x.detach().numpy().copy()
    dcfg, draft = port_model(draft_np, dict(n_layers=1, n_kv_heads=4))
    eng = SpecEngine(shard_for_serving(params, mesh, cfg), cfg, draft, dcfg, k=k,
                     max_slots=2, max_len=64, mesh=mesh)
    ids = [eng.submit(GenRequest(prompt=list(p), max_new_tokens=n))
           for p, n in zip(prompts, budgets)]
    got = eng.run()
    arrays["spec"] = _tokens_array([got[i] for i in ids])
    arrays["rounds"] = np.array(eng.stats()["rounds"])
    save(out, "lora_spec", rank, **arrays)

