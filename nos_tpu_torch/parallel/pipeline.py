"""Pipeline parallelism: a GPipe schedule over a ``pp`` mesh axis.

Counterpart of ``nos_tpu/parallel/pipeline.py``. The transformer stack
splits into pp stages: layer params stack along a leading dim
(``stack_layer_params``) sharded over ``pp``, so a rank holds its L/pp
layers. The batch splits into M microbatches that stream through the
stages: every tick each stage applies its layers to the microbatch it
holds and hands the activation to the next stage in one hop
(``comm.StageShift``, the reference's ``ppermute``). The schedule runs
M + pp - 1 ticks; the GPipe bubble is (pp - 1) / (M + pp - 1).

Embedding, final norm and head are replicated over pp (the dense rules,
``sharding.llama_param_sharding``); a stage's layers keep the dense
rules' dp and tp shards under ``pp`` (``pipeline_param_sharding``) and
are gathered whole once a step, before the schedule, as the reference's
shard_map gathers them on entry: over dp by ``comm.fsdp_gather`` (each
dp rank's gradient is its share, reduce-scattered back), over the other
axes by ``comm.gather_from_group`` (replicated compute: the rank's slice
of a whole gradient). Inside a stage nothing crosses ranks: attention
runs with no mesh, so ``attention="flash"`` launches the forward kernel
(and the two backward kernels in training) on the stage's microbatch.

Explicit SPMD, as every multi-device path of the port: a rank holds its
shards of the stacked tree and its tokens, ``pipeline_data_sharding``'s
``[M · (B/M)/dp, S]`` rows (microbatches ``x.reshape(M, B/M, S)``, dim 1
over dp, as the reference's ``_prepare_pipeline_inputs`` lays them).

Differences from the reference, all deliberate:

- A stage skips its compute on the bubble ticks, where it holds no valid
  microbatch (the reference computes them and discards the result). The
  outputs are the same; a rank launches the forward kernel M · L/pp
  times, not (M + pp - 1) · L/pp. Every hop still runs on every tick,
  and a bubble tick's output is the zero-weighted incoming activation,
  so each rank's hops form one chain through its autograd graph, from a
  stage weight (zero-weighted into the first hop) to the loss: the
  backward runs every rank's hops in the same order. (A hop whose output
  fed nothing, or whose input led to no param, would never run its
  backward, and its peer would wait.) So a gradient through the pipeline
  is taken with respect to every rank's layer params, as
  ``pipeline_loss_and_grads`` takes it.
- ``pipeline_llama_forward`` hands the last stage's activations to every
  stage with one broadcast (the reference's psum of zeros elsewhere).
- ``pipeline_llama_loss`` keeps the head and the NLL on the last stage
  and moves one scalar over pp, then means over dp (the reference's
  ``psum`` / ``pmean``). Its value is the global loss on every rank; its
  gradient on a rank is the rank's share, which
  ``pipeline_loss_and_grads`` completes (the counterpart of
  ``jax.value_and_grad`` over the reference's loss).
- MoE layers run ``moe_mlp`` per stage with no mesh: the capacity of the
  stage's local ``[(B/M)/dp, S]`` microbatch and no aux loss, the
  reference's shard_map semantics (not the global race of
  ``models/moe.py`` under a mesh).
- Under ``config.remat`` each tick's stage application is checkpointed
  (``torch.utils.checkpoint``), as the reference checkpoints it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch

from nos_tpu_torch.models.llama import (
    LlamaConfig,
    WeightNode,
    _attention,
    _embed_rows,
    _mlp,
    _mm,
    _rms_norm,
    _rope,
    next_token_nll,
    params_device,
    tree_leaves,
)
from nos_tpu_torch.parallel import comm
from nos_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    check_mesh_axes,
    mesh_groups,
)
from nos_tpu_torch.parallel.sharding import (
    _block as _take_block,
    _zip_map,
    gather_shard,
    llama_param_sharding,
    rule_leaves,
    take_shard,
)

Params = Dict[str, Any]

# the axes a pipeline mesh may carry; sp has no pipeline layout
PIPELINE_AXES = ("dp", "tp", "ep", "pp")


def _stack(items: List[Any]) -> Any:
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, WeightNode):
        return first.replace([torch.stack(ts) for ts in zip(*(n.tensors() for n in items))])
    return {key: _stack([item[key] for item in items]) for key in first}


def stack_layer_params(params: Params) -> Params:
    """``[{leaf ...}] * L`` → ``{leaf: [L, ...]}``, the pp-shardable
    layout (a MoE layer's ``moe`` node and weight nodes stacked tensor by
    tensor); the other keys are shared, not copied."""
    return {k: _stack(v) if k == "layers" else v for k, v in params.items()}


def _prepend_pp(rule, pp: str):
    if isinstance(rule, tuple):
        return (pp, *rule)
    if isinstance(rule, WeightNode):
        return rule.replace([(pp, *spec) for spec in rule.tensors()])
    return {key: _prepend_pp(value, pp) for key, value in rule.items()}


def pipeline_param_sharding(mesh, config: LlamaConfig) -> Params:
    """The rule tree of the stacked layout: the dense rules, with ``pp``
    prepended on dim 0 of every stacked layer leaf (hidden over tp and
    the FSDP dp shard inside each stage); embedding, final norm and head
    keep the dense rules, replicated over pp."""
    base = llama_param_sharding(mesh, config)
    pp = "pp" if axis_size(mesh, "pp") > 1 else None
    return {k: _prepend_pp(v[0], pp) if k == "layers" else v for k, v in base.items()}


def _rules(params: Params, mesh, config: LlamaConfig) -> Params:
    check_mesh_axes(mesh, PIPELINE_AXES)
    if config.n_layers % axis_size(mesh, "pp"):
        raise ValueError(
            f"{config.n_layers} layers do not divide {axis_size(mesh, 'pp')} pp stages"
        )
    rules = pipeline_param_sharding(mesh, config)
    if "lm_head" not in params:
        rules.pop("lm_head", None)
    return rules


def shard_pipeline_params(stacked: Params, mesh, config: LlamaConfig) -> Params:
    """This rank's shards of a whole stacked tree (copies): its stage's
    layers, dp- and tp-sharded by the dense rules, and its shards of
    the embedding, final norm and head."""
    rules = _rules(stacked, mesh, config)
    return _zip_map(lambda x, spec: take_shard(x, spec, mesh), stacked, rules)


def gather_pipeline_params(shards: Params, mesh, config: LlamaConfig) -> Params:
    """The whole stacked tree from every rank's shards (a collective:
    every rank of the mesh calls it), bit-exact."""
    rules = _rules(shards, mesh, config)
    return _zip_map(lambda x, spec: gather_shard(x, spec, mesh), shards, rules)


def pipeline_data_sharding(mesh, tokens: torch.Tensor, n_microbatches: int = 0):
    """This rank's rows of the global batch ``tokens`` [B, S]: the
    microbatches ``tokens.reshape(M, B/M, S)`` with dim 1 over dp, as
    ``[M · (B/M)/dp, S]`` (M defaults to pp)."""
    m = n_microbatches or axis_size(mesh, "pp")
    b = tokens.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not divide {m} microbatches")
    mb = tokens.reshape(m, b // m, *tokens.shape[1:])
    mine = _take_block(mb, 1, axis_index(mesh, "dp"), axis_size(mesh, "dp"))
    return mine.reshape(-1, *tokens.shape[1:])


# --------------------------------------------------------------- the stages


def _gather_whole(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``x`` (a shard under ``spec``) whole over every axis but pp: over
    dp by FSDP's gather (the gradient reduce-scattered back), over the
    others by a gather whose backward takes the rank's slice."""
    for dim, axis in enumerate(spec):
        if axis is None or axis == "pp":
            continue
        group = axis_group(mesh, axis)
        if axis == "dp":
            x = comm.fsdp_gather(x, group, dim)
        else:
            x = comm.gather_from_group(x, group, dim, kind=axis)
    return x


def _whole(tree, rules, mesh):
    """``_gather_whole`` over a params subtree and its rules."""
    return _zip_map(lambda x, spec: _gather_whole(x, spec, mesh), tree, rules)


def _layer_at(stacked, i: int):
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    if isinstance(stacked, WeightNode):
        return stacked.replace([t[i] for t in stacked.tensors()])
    return {key: _layer_at(value, i) for key, value in stacked.items()}


def _block(x, layer: Params, c: LlamaConfig, cos, sin):
    """One transformer block on one stage, no mesh: attention on the
    microbatch (the flash kernel under ``attention="flash"``), and a MoE
    layer's routed FFN at the microbatch's own capacity, without aux."""
    x = x + _attention(_rms_norm(x, layer["attn_norm"], c.norm_eps, c.norm_offset),
                       layer, c, cos, sin)
    h = _rms_norm(x, layer["mlp_norm"], c.norm_eps, c.norm_offset)
    if "moe" in layer:
        from nos_tpu_torch.models.moe import moe_mlp

        return x + moe_mlp(layer["moe"], h, c.moe_config())
    return x + _mlp(h, layer, c.hidden_act)


def _stage_apply(layers: List[Params], c: LlamaConfig, cos, sin, x):
    for layer in layers:
        x = _block(x, layer, c, cos, sin)
    return x


def _schedule(layers: List[Params], x_mb, m: int, shape, c: LlamaConfig, cos, sin, mesh):
    """The GPipe ticks on this rank's stage: ``x_mb`` [M, mb, S, D] is the
    embedded input (stage 0 only; None elsewhere). Returns (the M outputs,
    valid on the last stage only, and the last tick's activation, which
    the caller adds zero-weighted to its result so that every hop joins
    the graph)."""
    n, s = axis_size(mesh, "pp"), axis_index(mesh, "pp")
    group = axis_group(mesh, "pp")
    dev = cos.device
    stage = functools.partial(_stage_apply, layers, c, cos, sin)
    # The first hop's input hangs off a weight of the stage (zero-weighted),
    # so every hop's input leads to the params: autograd then runs every
    # hop's backward on every rank, none pruned as not needed.
    act = torch.zeros(shape, dtype=c.dtype, device=dev)
    if torch.is_grad_enabled():
        act = act + tree_leaves(layers[0])[0].reshape(-1)[0].to(c.dtype) * 0
    ys: List[torch.Tensor] = [None] * m
    for t in range(m + n - 1):
        incoming = comm.StageShift.apply(act, group) if group is not None else act
        if 0 <= t - s < m:
            x_in = x_mb[t] + incoming * 0 if s == 0 else incoming
            if c.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                out = checkpoint(stage, x_in, use_reentrant=False)
            else:
                out = stage(x_in)
            if s == n - 1:
                ys[t - s] = out
        else:  # a bubble tick: no compute, the hop kept in the chain
            out = incoming * 0
        act = out
    return ys, act


def _prepare(params: Params, tokens, c: LlamaConfig, mesh, n_microbatches: int):
    """Validation, this stage's whole layers, the rope tables and, on
    stage 0, the embedded microbatches."""
    rules = _rules(params, mesh, c)
    m = n_microbatches or axis_size(mesh, "pp")
    rows, s_len = tokens.shape
    if rows % m:
        raise ValueError(f"batch {rows} does not divide {m} microbatches")
    dev = params_device(params)
    tokens = tokens.to(dev)
    stacked = _whole(params["layers"], rules["layers"], mesh)
    local = c.n_layers // axis_size(mesh, "pp")
    layers = [_layer_at(stacked, i) for i in range(local)]
    cos, sin = _rope(s_len, c.head_dim, c.rope_theta, c.dtype, c.rope_scaling, device=dev)
    x_mb = None
    if axis_index(mesh, "pp") == 0:
        embed = _gather_whole(params["embed"], rules["embed"], mesh)
        x = _embed_rows(embed, tokens, c.dtype, c.embed_scale)
        x_mb = x.reshape(m, rows // m, s_len, c.d_model)
    return rules, m, layers, cos, sin, x_mb, tokens


def _head(params: Params, rules: Params, y, c: LlamaConfig, mesh) -> torch.Tensor:
    """Final norm and the unembedding (whole weights) → f32 logits."""
    h = _rms_norm(y, params["final_norm"], c.norm_eps, c.norm_offset)
    if "lm_head" in params:
        w = _gather_whole(params["lm_head"], rules["lm_head"], mesh)
    else:
        w = _gather_whole(params["embed"], rules["embed"], mesh).T
    return _mm(h, w).float()


def pipeline_llama_forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                           mesh, n_microbatches: int = 0) -> torch.Tensor:
    """tokens → logits [rows, S, vocab] f32, the transformer blocks
    pipelined over the mesh's ``pp`` axis. ``params`` are the rank's
    shards of the stacked layout (``shard_pipeline_params``), ``tokens``
    its rows (``pipeline_data_sharding``), which must divide into
    ``n_microbatches`` (default pp). Every pp rank returns the same
    logits: the last stage's activations are broadcast, and the final
    norm and head run replicated. Every rank of the mesh calls it."""
    c = config
    rules, m, layers, cos, sin, x_mb, tokens = _prepare(params, tokens, c, mesh,
                                                        n_microbatches)
    rows, s_len = tokens.shape
    shape = (rows // m, s_len, c.d_model)
    ys, _ = _schedule(layers, x_mb, m, shape, c, cos, sin, mesh)
    n = axis_size(mesh, "pp")
    if axis_index(mesh, "pp") == n - 1:
        y = torch.cat(ys)  # microbatch order is row order
    else:
        y = torch.empty((rows, s_len, c.d_model), dtype=c.dtype, device=cos.device)
    group = axis_group(mesh, "pp")
    if group is not None:
        y = comm.broadcast(y.detach(), group, n - 1, kind="pp_broadcast")
    return _head(params, rules, y, c, mesh)


def pipeline_llama_loss(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                        mesh, n_microbatches: int = 0) -> torch.Tensor:
    """Training loss with the head on the last stage: the final norm,
    head and next-token NLL run where the activations already are, and
    one scalar crosses pp; the mean over dp follows. The value is the
    global batch's loss on every rank; its gradient on a rank is the
    rank's share (``pipeline_loss_and_grads`` sums the shares)."""
    c = config
    rules, m, layers, cos, sin, x_mb, tokens = _prepare(params, tokens, c, mesh,
                                                        n_microbatches)
    rows, s_len = tokens.shape
    ys, last_act = _schedule(layers, x_mb, m, (rows // m, s_len, c.d_model), c, cos, sin,
                             mesh)
    n = axis_size(mesh, "pp")
    if axis_index(mesh, "pp") == n - 1:
        local = next_token_nll(_head(params, rules, torch.cat(ys), c, mesh), tokens)
    else:
        local = torch.zeros((), dtype=torch.float32, device=cos.device)
    if last_act.requires_grad:
        local = local + last_act.float().sum() * 0
    dp = axis_size(mesh, "dp")
    local = local / dp
    total = comm.all_reduce(local.detach(), mesh_groups(mesh, ("pp", "dp")), kind="pp")
    return total + (local - local.detach())


def pipeline_loss_and_grads(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                            mesh, n_microbatches: int = 0) -> Tuple[torch.Tensor, list]:
    """(``pipeline_llama_loss``, its gradient): one tensor per leaf of the
    rank's shards, in ``tree_leaves`` order, each the rank's shard of the
    whole gradient. A leaf sharded over dp got its dp sum from FSDP's
    reduce-scatter; every leaf is then summed in f32 over the axes among
    dp and pp it is replicated on (a stage's norms over dp, the
    embedding, final norm and head over pp). Nothing is summed over tp
    or ep (replicated compute)."""
    from nos_tpu_torch.parallel.train import _sum_over_mesh

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = pipeline_llama_loss(params, tokens, config, mesh, n_microbatches)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    specs = rule_leaves(_rules(params, mesh, config))
    out = list(grads)
    for axes in (("dp", "pp"), ("dp",), ("pp",)):
        idx = [i for i, spec in enumerate(specs)
               if tuple(a for a in ("dp", "pp") if a not in spec) == axes]
        groups = mesh_groups(mesh, axes)
        if idx and groups:
            summed = _sum_over_mesh([grads[i] for i in idx], [leaves[i] for i in idx], groups)
            for i, g in zip(idx, summed):
                out[i] = g
    return loss.detach(), out
