"""The training step, on one device or over a ``dp`` x ``sp`` x ``tp`` x ``ep`` mesh.

Counterpart of ``nos_tpu/parallel/train.py:make_train_step``: loss →
gradients → optimizer update. There is no ``jit``; the step runs
eagerly, and ``attention="flash"`` takes its gradients from the
hand-written backward kernels (in block mode on the ring).

Under a ``DeviceMesh`` with axes among ``dp``, ``sp``, ``tp`` and
``ep`` each rank holds its shards of the params (``sharding.shard_params``:
tp Megatron-style, FSDP over dp, experts over ep, norms and routers
replicated) and of the optimizer state, which is built on the shards and
so sharded like them by construction; it runs ``llama_loss`` on its
``[B/dp, S/sp]`` token block. Its gradient is its share of the
global-mean gradient, and the shares meet in one reduction a leaf, read
off its spec: a leaf sharded over dp (FSDP) gets its dp sum from the
reduce-scatter of its gathered weight's gradient in the backward and is
summed over sp here; a leaf replicated over dp (a norm, a router) is
summed over dp and sp here. Nothing is summed over tp or ep: a leaf's
gradient is already whole across tp (the ``copy_to_group`` before every
product that reads it all-reduces it) and across ep (replicated compute,
or the rank's own experts). Sums run in f32 (``comm.all_reduce``) before
the one update every rank applies to its shards.

State is ``(params, velocity)`` for the built-in momentum SGD, whose
velocity tree has the params' structure, or ``(params, optimizer)`` with
a ``torch.optim.Optimizer`` in the place of the optax state.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    WeightNode,
    _check_mesh,
    llama_loss,
    tree_leaves,
    tree_map,
)
from nos_tpu_torch.parallel.comm import all_reduce
from nos_tpu_torch.parallel.mesh import mesh_groups
from nos_tpu_torch.parallel.sharding import param_rules, rule_leaves, shard_params

# Gradients cross the mesh in f32 buckets of about this many elements
# (256 MB), so the f32 copy never holds the whole tree at once.
BUCKET_ELEMENTS = 1 << 26


def _same_structure(tree, rules) -> bool:
    """Whether ``tree`` is params-structured like the rule tree."""
    if isinstance(rules, tuple) or isinstance(tree, (torch.Tensor, WeightNode)):
        return isinstance(rules, (tuple, WeightNode)) and \
            isinstance(tree, (torch.Tensor, WeightNode))
    if isinstance(rules, dict):
        return isinstance(tree, dict) and tree.keys() == rules.keys() and \
            all(_same_structure(tree[k], rules[k]) for k in rules)
    if isinstance(rules, list):
        return isinstance(tree, (list, tuple)) and len(tree) == len(rules) and \
            all(_same_structure(t, r) for t, r in zip(tree, rules))
    return False


def optimizer_state_sharding(opt_state, param_sharding, mesh):
    """The specs of optimizer state (``sharding.llama_param_sharding``
    gives ``param_sharding``): a params-structured tree (the built-in
    SGD's velocity) takes the params' rules wholesale; a
    ``torch.optim.Optimizer`` gives each of its params' state tensors of
    the param's shape the param's spec and every other one (a step
    count) replication, as ``{param index: {name: spec}}`` in
    ``tree_leaves`` order. Raises ``ValueError`` for state with no
    param-shaped part, which would otherwise replicate whole."""
    if _same_structure(opt_state, param_sharding):
        return param_sharding
    if isinstance(opt_state, torch.optim.Optimizer):
        specs = rule_leaves(param_sharding)
        params = [p for group in opt_state.param_groups for p in group["params"]]
        out, found = {}, 0
        for i, p in enumerate(params):
            entry = {}
            for name, value in opt_state.state.get(p, {}).items():
                if isinstance(value, torch.Tensor) and value.shape == p.shape and value.dim():
                    entry[name] = specs[i]
                    found += 1
                else:
                    entry[name] = ()
            out[i] = entry
        if found or not opt_state.state:
            return out
    raise ValueError(
        "optimizer state contains no params-structured part; its moments "
        "would be fully replicated. Use the built-in SGD or a torch.optim "
        "optimizer over the param leaves."
    )


def _sum_over_mesh(grads, params, groups):
    """Each gradient summed over ``groups`` in f32, in buckets of about
    BUCKET_ELEMENTS, then rounded once to its param's dtype."""
    out = [None] * len(grads)
    bucket: list = []

    def flush():
        flat = torch.cat([grads[i].float().reshape(-1) for i in bucket])
        flat = all_reduce(flat, groups, kind="grad_sum")
        at = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view(grads[i].shape).to(params[i].dtype)
            at += n
        bucket.clear()

    size = 0
    for i, g in enumerate(grads):
        bucket.append(i)
        size += g.numel()
        if size >= BUCKET_ELEMENTS:
            flush()
            size = 0
    if bucket:
        flush()
    return out


def sum_gradients(grads, leaves, mesh, specs, cast: bool = False) -> list:
    """Each rank's gradient shares (of ``leaves``, its param shards, in
    order, with their degraded ``specs``) summed over the data axes each
    leaf is not sharded on and has not been summed over yet: a leaf whose
    spec names dp (the reduce-scatter in the backward summed it over dp)
    over sp, any other over dp and sp; never over tp or ep. In f32,
    rounded once to the param dtype; ``cast``: a leaf with nothing to sum
    still rounds (f32 accumulators)."""
    out = list(grads)
    for axes, sharded in ((("sp",), True), (("dp", "sp"), False)):
        idx = [i for i, spec in enumerate(specs) if ("dp" in spec) == sharded]
        groups = mesh_groups(mesh, axes)
        if not idx:
            continue
        if groups:
            summed = _sum_over_mesh([grads[i] for i in idx], [leaves[i] for i in idx], groups)
        else:
            summed = [grads[i].to(leaves[i].dtype) if cast else grads[i] for i in idx]
        for i, g in zip(idx, summed):
            out[i] = g
    return out


def make_train_step(
    mesh,
    config: LlamaConfig,
    learning_rate: float = 1e-3,
    momentum: float = 0.9,
    optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None,
    accum_steps: int = 1,
    device=None,
):
    """Returns ``(train_step, shard_state)`` where
    ``train_step(state, tokens) -> (state, loss)``, ``loss`` a 0-d tensor
    on the device (no host sync).

    ``mesh``: None for one device, or a ``DeviceMesh`` over ``dp`` /
    ``sp`` / ``tp`` (see the module docstring). Under a mesh ``tokens``
    is this rank's block of the global batch, ``[accum_steps * B/dp,
    S/sp]`` (``sharding.llama_data_sharding``, or
    ``BatchLoader(mesh=...)`` through ``prefetch_to_device(mesh=...)``),
    the same on every tp rank; the loss is the global batch's on every
    rank; the state holds the rank's shards (``sharding.gather_params``
    gathers them whole), and the whole params given to ``shard_state``
    must be the same on every rank (one seed, one checkpoint).

    Built-in update (``optimizer=None``, state ``(params, velocity)``):
    ``v = momentum * v + g``, ``p -= learning_rate * v``, each rounded to
    the param dtype as the reference rounds it. The update runs IN PLACE
    under ``torch.no_grad()``, in the place of the reference's buffer
    donation: the state passed in is the state returned, updated.

    ``optimizer``: a factory ``params_list -> torch.optim.Optimizer`` in
    the place of an optax transformation, e.g.
    ``functools.partial(torch.optim.AdamW, lr=..., weight_decay=...)``.
    The optimizer then owns the hyperparameters, so non-default
    ``learning_rate`` / ``momentum`` beside it raise.

    ``accum_steps`` > 1: ``tokens`` [accum * B, S] runs as ``accum_steps``
    micro-batches in turn (one backward's activations live at a time),
    gradients summed in f32, scaled by 1 / accum_steps and cast back to
    the param dtype before one update; the loss is the micro-batch mean.
    """
    _check_mesh(mesh, config)
    if optimizer is not None and (learning_rate != 1e-3 or momentum != 0.9):
        raise ValueError(
            "learning_rate/momentum configure the built-in SGD update; an "
            "optimizer factory carries its own hyperparameters — set them "
            "there instead"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    dev = _resolve_device(device)

    def grads_of(params: Params, leaves, tokens):
        specs = None if mesh is None else rule_leaves(param_rules(params, mesh, config))
        if accum_steps == 1:
            loss = llama_loss(params, tokens, config, mesh)
            grads = torch.autograd.grad(loss, leaves)
            if mesh is not None:
                grads = sum_gradients(grads, leaves, mesh, specs)
            return loss.detach(), grads
        total_b = tokens.shape[0]
        if total_b % accum_steps:
            raise ValueError(
                f"batch {total_b} is not divisible by accum_steps {accum_steps}"
            )
        micro = tokens.reshape(accum_steps, total_b // accum_steps, -1)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in leaves]
        for batch in micro:
            loss = llama_loss(params, batch, config, mesh)
            for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves)):
                acc += g.float()
            loss_sum += loss.detach()
        scale = 1.0 / accum_steps
        g_sum = [g.mul_(scale) for g in g_sum]
        if mesh is None:
            return loss_sum * scale, [g.to(p.dtype) for g, p in zip(g_sum, leaves)]
        return loss_sum * scale, sum_gradients(g_sum, leaves, mesh, specs, cast=True)

    def train_step(state, tokens):
        params, opt = state
        tokens = torch.as_tensor(tokens, device=dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, grads = grads_of(params, leaves, tokens)
        if optimizer is not None:
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            return (params, opt), loss
        with torch.no_grad():
            for p, v, g in zip(leaves, tree_leaves(opt), grads):
                v.mul_(momentum).add_(g.to(v.dtype))
                p.sub_(v * learning_rate)
        return (params, opt), loss

    def shard_state(params: Params, donate: bool = False):
        """Place (params, optimizer state) on the device: zero velocity
        for the built-in SGD, ``optimizer(params_list)`` otherwise. Under
        a mesh ``params`` is the whole tree, the same on every rank, and
        the rank keeps its shards (copies; the optimizer state is built
        on them). By default the params are copied, so the caller's
        tensors stay valid and untouched by the in-place updates;
        ``donate=True`` hands them over instead (no copy when they
        already lie on the device), which halves peak memory for freshly
        initialised params."""
        if mesh is not None:
            params = shard_params(tree_map(lambda p: p.detach(), params), mesh, config)
            params = tree_map(lambda p: p.to(dev), params)
        elif donate:
            params = tree_map(lambda p: p.detach().to(dev), params)
        else:
            params = tree_map(lambda p: p.detach().to(dev, copy=True), params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if optimizer is not None:
            return params, optimizer(leaves)
        return params, tree_map(torch.zeros_like, params)

    return train_step, shard_state
