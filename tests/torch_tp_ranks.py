"""The rank side of the port's tensor-parallel, FSDP, sharded-serving and
checkpoint CPU tests.

The test files (``tests/test_torch_tp.py``, ``test_torch_fsdp.py``,
``test_torch_sharded_serve.py``, ``test_torch_checkpoint.py``) compute
the reference's results in the parent process, JAX on the conftest's
virtual CPU devices over a mesh of the same shape, and spawn gloo ranks
(``tests/torch_sp_ranks.py:spawn``) that run the functions below on the
rank's shards and write ``.npz`` results. Every rank of a mesh writes
its own file; whole tensors are gathered from the shards
(``sharding.gather_params``) before they are written.

This module imports no JAX: every spawned rank imports it afresh.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from tests.torch_sp_ranks import block, cpu_mesh, mesh_loss_grads, port_model, save


def tp_model(rank, out, dims, names, params_np, tokens, cases) -> None:
    """Each case ``(name, overrides)`` on the mesh: ``llama_forward``'s
    logits of this rank's block, ``llama_loss`` and its whole gradient
    (the ranks' shares summed as the trainer sums them, gathered)."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel.sharding import shard_params

    mesh = cpu_mesh(dims, names)
    for name, overrides in cases:
        cfg, params = port_model(params_np, overrides)
        with torch.no_grad():
            logits = llama.llama_forward(shard_params(params, mesh, cfg),
                                         block(mesh, tokens), cfg, mesh)
        loss, grads = mesh_loss_grads(params, tokens, cfg, mesh)
        save(out, name, rank, logits=logits.numpy(), loss=loss.numpy(),
             **{f"g{i}": g.numpy() for i, g in enumerate(grads)})


def tp_contracts(rank, out, params_np) -> None:
    """The head-divisibility and kv_quant raises on real meshes; a rank
    writes each case's error text (or "no error")."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step, sharding
    from nos_tpu_torch.serve import Engine, kv_cache_sharding, shard_for_serving

    tp4 = cpu_mesh((4,), ("tp",))
    tp2 = cpu_mesh((2, 2), ("dp", "tp"))
    cfg, params = port_model(params_np, {})
    kv2 = llama.tiny_config(dtype=torch.float32, n_kv_heads=2)
    mqa = llama.tiny_config(dtype=torch.float32, n_kv_heads=1)
    toks = torch.zeros((1, 4), dtype=torch.long)
    cases = {
        "cache_kv2_tp4": lambda: kv_cache_sharding(tp4, kv2),
        "forward_kv2_tp4": lambda: llama.llama_forward(params, toks, kv2, tp4),
        "train_mqa_tp2": lambda: make_train_step(tp2, mqa, device="cpu"),
        "shard_kv2_tp4": lambda: sharding.shard_params(params, tp4, kv2),
        "serve_kv2_tp4": lambda: shard_for_serving(params, tp4, kv2),
        "engine_kv2_tp4": lambda: Engine(params, kv2, mesh=tp4),
        "engine_kv_quant": lambda: Engine(params, cfg, mesh=tp2, kv_quant=True),
        "bits": lambda: sharding.llama_quantized_sharding(tp2, cfg, bits=3),
    }
    errors = {}
    for key, fn in cases.items():
        try:
            fn()
            errors[key] = "no error"
        except (ValueError, NotImplementedError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    save(out, "tp_contracts", rank, **{k: np.array(v) for k, v in errors.items()})


# ------------------------------------------------------------------ train


def fsdp_train(rank, out, dims, names, params_np, runs) -> None:
    """Each run ``(name, overrides, batches, step_kwargs, adamw)``:
    ``make_train_step`` over the mesh from the same whole params, the
    losses and the gathered params (and velocity) after the last step,
    and the rank's bytes: its param shards, its optimizer state, and the
    replicated (1-D) leaves."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step
    from nos_tpu_torch.parallel.sharding import gather_params

    mesh = cpu_mesh(dims, names)

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    for name, overrides, batches, step_kwargs, adamw in runs:
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
        shards = llama.tree_leaves(state[0])
        if adamw is None:
            opt = llama.tree_leaves(state[1])
        else:
            opt = [t for entry in state[1].state.values() for t in entry.values()
                   if isinstance(t, torch.Tensor) and t.dim()]
        arrays = {"losses": np.array(losses),
                  "param_bytes": np.array(nbytes(shards)),
                  "opt_bytes": np.array(nbytes(opt)),
                  "replicated_bytes": np.array(nbytes(p for p in shards if p.dim() == 1))}
        whole = gather_params(llama.tree_map(lambda p: p.detach(), state[0]), mesh, cfg)
        for i, p in enumerate(llama.tree_leaves(whole)):
            arrays[f"p{i}"] = p.numpy()
        if adamw is None:
            for i, v in enumerate(llama.tree_leaves(gather_params(state[1], mesh, cfg))):
                arrays[f"v{i}"] = v.numpy()
        save(out, name, rank, **arrays)


def optimizer_rules(rank, out, params_np) -> None:
    """``optimizer_state_sharding`` of the velocity tree, of an AdamW's
    state after a step, and its raise for state of another shape."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step
    from nos_tpu_torch.parallel.sharding import llama_param_sharding, rule_leaves
    from nos_tpu_torch.parallel.train import optimizer_state_sharding

    mesh = cpu_mesh((2, 2), ("dp", "tp"))
    cfg, params = port_model(params_np, {})
    rules = llama_param_sharding(mesh, cfg)
    _, shard = make_train_step(mesh, cfg, device="cpu")
    velocity_rules = optimizer_state_sharding(shard(params)[1], rules, mesh)
    step, shard = make_train_step(mesh, cfg, device="cpu",
                                  optimizer=functools.partial(torch.optim.AdamW, lr=1e-3))
    state = shard(params)
    state, _ = step(state, block(mesh, np.zeros((4, 8), np.int64)))
    adam = optimizer_state_sharding(state[1], rules, mesh)
    try:
        optimizer_state_sharding({"count": torch.zeros(())}, rules, mesh)
        other = "no error"
    except ValueError as e:
        other = f"ValueError: {e}"
    specs = rule_leaves(rules)
    save(out, "optimizer_rules", rank,
         velocity_same=np.array(velocity_rules is rules),
         adam_moments=np.array([adam[i]["exp_avg"] == specs[i] and
                                adam[i]["exp_avg_sq"] == specs[i] for i in adam]),
         adam_steps=np.array([adam[i]["step"] == () for i in adam]),
         n_entries=np.array(len(adam)), n_leaves=np.array(len(llama.tree_leaves(params))),
         other=np.array(other))


# ---------------------------------------------------------------- serving


def tp_serve(rank, out, dims, names, params_np, prompts, cases) -> None:
    """Each case ``(name, fmt, group)``: the tp ``Engine`` over the rank's
    ``shard_for_serving`` shards of the dense (f32), int8 or int4 tree
    (quantized on the rank from the bridged weights, as the reference
    quantizes its own), serving ``prompts`` with budgets 5, 6, ...; the
    completions, and the rank's weight and cache bytes."""
    from nos_tpu_torch.models import quantize
    from nos_tpu_torch.serve import Engine, GenRequest, shard_for_serving

    mesh = cpu_mesh(dims, names)
    cfg, params = port_model(params_np, {})
    for name, fmt, group in cases:
        tree = {"f32": lambda: params,
                "int8": lambda: quantize.quantize_params(params),
                "int4": lambda: quantize.quantize_params_int4(params, group=group)}[fmt]()
        eng = Engine(shard_for_serving(tree, mesh, cfg), cfg, max_slots=2, max_len=64,
                     ticks_per_sync=4, mesh=mesh)
        ids = [eng.submit(GenRequest(prompt=list(p), max_new_tokens=5 + i))
               for i, p in enumerate(prompts)]
        got = eng.run()
        width = max(len(got[i]) for i in ids)
        tokens = np.full((len(ids), width), -1, np.int64)
        for row, rid in enumerate(ids):
            tokens[row, :len(got[rid])] = got[rid]
        cache = [t for layer in eng._cache for t in layer.values()]
        save(out, name, rank, tokens=tokens,
             weight_bytes=np.array(quantize.weight_bytes(eng.params)),
             cache_bytes=np.array(sum(t.numel() * t.element_size() for t in cache)),
             cache_heads=np.array(eng._cache[0]["k"].shape[2]))


# ------------------------------------------------------------- checkpoint


def checkpoint_cases(rank, out, params_np, batches, adamw) -> None:
    """Save a dp 2 x tp 2 state after a step; restore it on the same mesh,
    onto tp 4 (then one more step there), and onto one device (rank 0);
    the async Checkpointer loop with its stale-step raise. Writes the
    saved state gathered whole and each restore gathered whole."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import checkpoint as ck
    from nos_tpu_torch.parallel import make_train_step
    from nos_tpu_torch.parallel.sharding import gather_params

    kwargs = {} if adamw is None else dict(
        optimizer=functools.partial(torch.optim.AdamW, **adamw))
    tag = "sgd" if adamw is None else "adamw"
    cfg, params = port_model(params_np, {})
    _, other = port_model(params_np, {})  # a second copy, overwritten by restores
    other = llama.tree_map(lambda p: torch.zeros_like(p), other)
    a = cpu_mesh((2, 2), ("dp", "tp"))
    b = cpu_mesh((4,), ("tp",))
    step_a, shard_a = make_train_step(a, cfg, device="cpu", **kwargs)
    step_b, shard_b = make_train_step(b, cfg, device="cpu", **kwargs)
    path = os.path.join(str(out), f"ckpt_{tag}")

    def whole(state, mesh):
        trees = [llama.tree_map(lambda p: p.detach(), state[0])]
        if adamw is None:
            trees.append(state[1])
        # copies: a replicated leaf gathers to itself, and steps update in place
        return [t.clone().numpy() for tree in trees
                for t in llama.tree_leaves(gather_params(tree, mesh, cfg) if mesh else tree)]

    state = shard_a(params)
    state, _ = step_a(state, block(a, batches[0]))
    ck.save_checkpoint(path, state, 5, mesh=a)
    arrays = {"latest": np.array(ck.latest_step(path))}
    saved = whole(state, a)
    same, s_same = ck.restore_checkpoint(path, shard_a(other), mesh=a)
    onto, s_onto = ck.restore_checkpoint(path, shard_b(other), mesh=b)
    arrays.update(steps=np.array([s_same, s_onto]))
    for key, got in (("saved", saved), ("same", whole(same, a)), ("onto", whole(onto, b))):
        for i, x in enumerate(got):
            arrays[f"{key}{i}"] = x
    if adamw is not None:
        arrays["adam_steps"] = np.array([float(e["step"]) for e in onto[1].state.values()])
    onto, loss = step_b(onto, block(b, batches[1]))
    cont, _ = step_a(state, block(a, batches[1]))
    arrays["continued_loss"] = np.array(float(loss))
    for i, (x, y) in enumerate(zip(whole(onto, b), whole(cont, a))):
        arrays[f"cont_b{i}"], arrays[f"cont_a{i}"] = x, y
    if rank == 0:
        step_1, shard_1 = make_train_step(None, cfg, device="cpu", **kwargs)
        single, s_single = ck.restore_checkpoint(path, shard_1(other), step=5)
        for i, x in enumerate(whole(single, None)):
            arrays[f"one{i}"] = x
        arrays["one_step"] = np.array(s_single)
    loop = os.path.join(str(out), f"loop_{tag}")
    with ck.Checkpointer(loop, mesh=a, max_to_keep=2) as c:
        for i in range(3):
            state, _ = step_a(state, block(a, batches[0]))
            c.save(i, state)
        c.wait()
        arrays["loop_latest"] = np.array(c.latest_step())
        arrays["loop_kept"] = np.array(sorted(os.listdir(loop)))
        last = whole(state, a)
        restored, s_loop = c.restore(shard_a(other))
        arrays["loop_restored_step"] = np.array(s_loop)
        arrays["loop_exact"] = np.array(all(
            np.array_equal(x, y) for x, y in zip(whole(restored, a), last)))
        try:
            c.save(1, state)
            arrays["stale"] = np.array("no error")
        except RuntimeError as e:
            arrays["stale"] = np.array(f"RuntimeError: {e}")
    try:
        ck.save_checkpoint(path, state, 5, mesh=a)
        arrays["stale_sync"] = np.array("no error")
    except RuntimeError as e:
        arrays["stale_sync"] = np.array(f"RuntimeError: {e}")
    ck.save_checkpoint(path, state, 5, mesh=a, force=True)
    forced, _ = ck.restore_checkpoint(path, shard_a(other), mesh=a)
    arrays["forced_exact"] = np.array(all(
        np.array_equal(x, y) for x, y in zip(whole(forced, a), whole(state, a))))
    save(out, f"ckpt_{tag}", rank, **arrays)



# ------------------------------------------------------------- examples


def example_clip(rank, out, params_np, grads_np, meshes, hyper) -> None:
    """One ``ClippedAdamW`` step (the train_llama example's optimizer) on
    each ``(dp, tp)`` mesh: the rank's shards of ``params_np`` take their
    shards of ``grads_np`` as gradients; the global norm, the clipped
    gradients and the stepped params are gathered whole."""
    from nos_tpu_torch.examples.train_llama import ClippedAdamW
    from nos_tpu_torch.models.llama import tree_leaves
    from nos_tpu_torch.parallel.sharding import (
        gather_params, param_rules, rule_leaves, shard_params,
    )

    for dims in meshes:
        mesh = cpu_mesh(dims, ("dp", "tp"))
        cfg, params = port_model(params_np, {})
        _, grads = port_model(grads_np, {})
        specs = rule_leaves(param_rules(params, mesh, cfg))
        shards, gshards = shard_params(params, mesh, cfg), shard_params(grads, mesh, cfg)
        for p, g in zip(tree_leaves(shards), tree_leaves(gshards)):
            p.requires_grad_(True)
            p.grad = g
        opt = ClippedAdamW(tree_leaves(shards), mesh=mesh, specs=specs, **hyper)
        opt.step()
        clipped = gather_params(gshards, mesh, cfg)
        stepped = gather_params(tree_map_detach(shards), mesh, cfg)
        save(out, f"clip_{dims[0]}x{dims[1]}", rank, norm=opt.last_norm.numpy(),
             **{f"g{i}": g.numpy() for i, g in enumerate(tree_leaves(clipped))},
             **{f"p{i}": p.numpy() for i, p in enumerate(tree_leaves(stepped))})


def tree_map_detach(tree):
    from nos_tpu_torch.models.llama import tree_map

    return tree_map(lambda t: t.detach(), tree)


def example_train(rank, out, steps) -> None:
    """The train_llama example's ``main`` on this rank's group: the
    examples lay their ("dp", "tp") mesh over the running ranks."""
    from nos_tpu_torch.examples import train_llama

    result = train_llama.main(["--device", "cpu", "--steps", str(steps),
                               "--checkpoint-every", "2",
                               "--ckpt-dir", os.path.join(str(out), "ckpt")])
    save(out, "example_train", rank,
         losses=np.array([result["losses"][k] for k in sorted(result["losses"])]),
         norms=np.array([result["grad_norms"][k] for k in sorted(result["grad_norms"])]),
         mesh=np.array(sorted(result["mesh"].items())),
         latest=np.array(result["latest_checkpoint"]))
