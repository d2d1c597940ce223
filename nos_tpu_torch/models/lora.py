"""LoRA: low-rank adapters on the attention / MLP projections, in PyTorch.

Counterpart of ``nos_tpu/models/lora.py``. Adapters attach as
``WeightNode`` leaves (``LoraLinear``, ``MultiLoraLinear``) that the
model's ``_mm`` dispatch already understands, so ``llama_forward``,
``generate``, ``prefill`` and the engine run adapted weights unchanged.
The adapter product ``(x @ A) @ B`` keeps the low-rank structure and
never materializes the [in, out] delta.

``make_lora_train_step`` trains only the adapters, on one device or over
a mesh, with a ``torch.optim`` optimizer in the place of optax
(``torch.optim.Adam`` by default: the same update as ``optax.adam``, eps
outside the square root); the base is read, never written.

Under a mesh (the reference's ``make_lora_train_step(mesh, ...)``) the
base is the rank's shards (``sharding.shard_params``, dense rules, FSDP
over dp), the tokens its ``[B/dp, S/sp]`` block, and the adapters and
their Adam state are replicated. Under tp a column-parallel target
(``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``) multiplies by the rank's
columns of B, a row-parallel one (``wo``, ``w_down``) by the rank's rows
of A, whose partial product joins the tp reduce after the base product
(B is linear: ``Σ_r (x_r A_r) B = (x A) B``). Each adapter leaf then
takes its whole gradient on every rank: summed over dp and sp as any
replicated leaf; over tp summed where each rank gives a part of it (A of
a column target, B of a row target) and gathered where each rank gives
a disjoint slice (B of a column target, A of a row target). Either
mistake would give tp x or 1/tp of a gradient, which a one-step loss
check can miss and three Adam steps do not. Multi-LoRA serving under a
mesh raises (``serve/engine.py``): the reference's ``shard_for_serving``
has no rule for adapter nodes either.

An adapter over a quantized base is not supported, as in the reference
(whose ``x @ w`` fails on a quantized node): merge, then quantize.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import (
    WeightNode,
    llama_loss,
    map_leaves,
    tree_leaves,
    tree_map,
)

Params = Dict[str, Any]

# Projections LoRA understands (2-D [in, out] leaves of a llama layer).
_TARGETABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # Which per-layer projections get adapters (Q and V, the classic pick).
    targets: Tuple[str, ...] = ("wq", "wv")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _dense_base(w) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise TypeError(
            f"LoRA over a {type(w).__name__} base is not supported: merge "
            "the adapters into the dense weights (merge_lora), then quantize"
        )
    return w


@dataclass
class LoraLinear(WeightNode):
    """Frozen base weight [in, out] + trainable low-rank delta
    A [in, r] @ B [r, out], applied on the fly."""

    w: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scale: float = 1.0
    TENSORS = ("w", "a", "b")

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        base = x @ _dense_base(self.w)
        delta = (x @ self.a.to(x.dtype)) @ self.b.to(x.dtype)
        return base + self.scale * delta


@dataclass
class MultiLoraLinear(WeightNode):
    """Frozen base weight + N STACKED adapters with a per-ROW selector:
    row b of the batch applies adapter ``idx[b]`` (multi-tenant serving:
    every engine slot can run a different fine-tune against one base).
    Adapter 0 is the identity (a zero delta)."""

    w: torch.Tensor      # [in, out] shared base
    a: torch.Tensor      # [N, in, r]
    b: torch.Tensor      # [N, r, out]
    idx: torch.Tensor    # [B] int: row -> adapter id
    scale: float = 1.0
    TENSORS = ("w", "a", "b", "idx")

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(
                f"MultiLoraLinear needs [B, S, d] activations, got {tuple(x.shape)}"
            )
        base = x @ _dense_base(self.w)
        a_sel = self.a[self.idx].to(x.dtype)   # [B, in, r]
        b_sel = self.b[self.idx].to(x.dtype)   # [B, r, out]
        delta = torch.bmm(torch.bmm(x, a_sel), b_sel)
        return base + self.scale * delta


def _target_of(layer: Params, t: str):
    if t not in layer:
        raise ValueError(
            f"LoRA target {t!r} absent from layer (MoE layers have no dense "
            "MLP projections)"
        )
    return layer[t]


def stack_lora_adapters(params: Params, adapter_trees, lora: LoraConfig,
                        rows: int = 1) -> Params:
    """Base params + a LIST of adapter trees → serving tree whose targeted
    projections are MultiLoraLinear nodes. Adapter ids are 1-based (id 0
    = identity, stacked as zeros); every adapter shares the LoraConfig.
    ``rows`` sizes the per-row selector (the engine's slot count),
    initialized to 0."""
    if not adapter_trees:
        raise ValueError(
            "stack_lora_adapters needs at least one adapter tree "
            "(a base-only engine doesn't need the stacked form)"
        )
    for ad in adapter_trees:
        _check_layer_counts(params, ad)
    idx = torch.zeros((rows,), dtype=torch.int32,
                      device=tree_leaves(params["layers"])[0].device)
    out = dict(params)
    out["layers"] = []
    for li, base_layer in enumerate(params["layers"]):
        layer = dict(base_layer)
        for t in lora.targets:
            w = _target_of(layer, t)
            first = adapter_trees[0]["layers"][li][t]
            stacks = {
                ab: torch.stack([torch.zeros_like(first[ab])]
                                + [ad["layers"][li][t][ab] for ad in adapter_trees])
                for ab in ("a", "b")
            }
            layer[t] = MultiLoraLinear(w=w, a=stacks["a"], b=stacks["b"], idx=idx,
                                       scale=lora.scale)
        out["layers"].append(layer)
    return out


def with_adapter_rows(params: Params, idx) -> Params:
    """Same tree with every MultiLoraLinear's row selector replaced by
    ``idx`` (its length sets the batch rows): the engine points decode
    at its slots' adapters and admission at one row, copying no weight."""
    idx_t = None

    def swap(leaf):
        nonlocal idx_t
        if not isinstance(leaf, MultiLoraLinear):
            return leaf
        if idx_t is None:
            idx_t = torch.as_tensor(idx, dtype=torch.int32).to(leaf.a.device)
        return MultiLoraLinear(w=leaf.w, a=leaf.a, b=leaf.b, idx=idx_t,
                               scale=leaf.scale)

    return map_leaves(swap, params)


def n_adapters(params: Params) -> int:
    """Stacked adapter count (the identity at id 0 included), or 0 for a
    tree without MultiLoraLinear nodes."""
    for layer in params["layers"]:
        for leaf in layer.values():
            if isinstance(leaf, MultiLoraLinear):
                return leaf.a.shape[0]
    return 0


def init_lora_params(config, lora: LoraConfig, seed: int = 0, device=None) -> Params:
    """Adapter tree mirroring params['layers']: per layer, per target,
    {'a': [in, r] normal / sqrt(in), 'b': [r, out] ZEROS}, so step 0 is
    the base model bit for bit. Drawn on ``device`` from a seeded
    generator; not the reference's numbers (``jax.random`` has no torch
    twin): bridge its adapters (``bridge.lora_from_numpy``) to compare.
    Adapters stay f32 (Adam's small steps would round away in bf16);
    the products cast them per use."""
    for t in lora.targets:
        if t not in _TARGETABLE:
            raise ValueError(f"unknown LoRA target {t!r}; choose from {_TARGETABLE}")
    c = config
    dev = _resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd = c.head_dim
    dims = {
        "wq": (c.d_model, c.n_heads * hd),
        "wk": (c.d_model, c.n_kv_heads * hd),
        "wv": (c.d_model, c.n_kv_heads * hd),
        "wo": (c.n_heads * hd, c.d_model),
        "w_gate": (c.d_model, c.d_ff),
        "w_up": (c.d_model, c.d_ff),
        "w_down": (c.d_ff, c.d_model),
    }
    layers = []
    for _ in range(c.n_layers):
        layer = {}
        for t in lora.targets:
            d_in, d_out = dims[t]
            a = torch.randn((d_in, lora.rank), generator=gen, device=dev)
            layer[t] = {
                "a": a / math.sqrt(d_in),
                "b": torch.zeros((lora.rank, d_out), dtype=torch.float32, device=dev),
            }
        layers.append(layer)
    return {"layers": layers}


def _check_layer_counts(params: Params, lora_params: Params) -> None:
    n_base, n_ad = len(params["layers"]), len(lora_params["layers"])
    if n_base != n_ad:
        # zip would silently truncate the model to the shorter tree
        raise ValueError(
            f"adapter tree has {n_ad} layers but the model has {n_base}; "
            "the adapters were built for a different config"
        )


def attach_lora(params: Params, lora_params: Params, lora: LoraConfig) -> Params:
    """Base params + adapters → forward-ready tree with LoraLinear nodes at
    the targeted projections (everything else shared, not copied)."""
    _check_layer_counts(params, lora_params)
    out = dict(params)
    out["layers"] = []
    for base_layer, ad_layer in zip(params["layers"], lora_params["layers"]):
        layer = dict(base_layer)
        for t, ab in ad_layer.items():
            layer[t] = LoraLinear(w=_target_of(layer, t), a=ab["a"], b=ab["b"],
                                  scale=lora.scale)
        out["layers"].append(layer)
    return out


def merge_lora(params: Params, lora_params: Params, lora: LoraConfig) -> Params:
    """Fold the adapters into dense weights: W + (alpha/r) A @ B in f32,
    cast back to W's dtype (the serving artifact: it quantizes and
    serves like any checkpoint)."""
    _check_layer_counts(params, lora_params)
    out = dict(params)
    out["layers"] = []
    for base_layer, ad_layer in zip(params["layers"], lora_params["layers"]):
        layer = dict(base_layer)
        for t, ab in ad_layer.items():
            w = _target_of(layer, t)
            delta = (ab["a"].float() @ ab["b"].float()) * lora.scale
            layer[t] = (w.float() + delta).to(w.dtype)
        out["layers"].append(layer)
    return out


def _tp_split(target: str):
    """(adapter factor, dim) that a tp rank slices for ``target``: the
    rows of A for a row-parallel product, the columns of B for a
    column-parallel one."""
    from nos_tpu_torch.parallel.sharding import leaf_rule

    return ("a", 0) if leaf_rule(target, torch.empty(0, 0))[0] == "tp" else ("b", 1)


def _rank_adapters(adapters: Params, mesh) -> Params:
    """The adapters as this tp rank multiplies by them: each target's
    sliced factor narrowed to the rank's block (views, so a gradient
    lands in the whole leaf's block); the adapters themselves without
    tp."""
    from nos_tpu_torch.parallel.mesh import axis_index, axis_size

    tp = axis_size(mesh, "tp")
    if tp == 1:
        return adapters
    r = axis_index(mesh, "tp")
    layers = []
    for layer in adapters["layers"]:
        out = {}
        for t, ab in layer.items():
            key, dim = _tp_split(t)
            size = ab[key].shape[dim] // tp
            out[t] = dict(ab, **{key: ab[key].narrow(dim, r * size, size)})
        layers.append(out)
    return {"layers": layers}


def _whole_adapter_grads(grads, adapters: Params, mesh) -> list:
    """Each adapter leaf's gradient share (in ``tree_leaves`` order) made
    whole on every rank: summed over dp and sp, then over tp a sum of the
    ranks' parts or a gather of their disjoint slices."""
    from nos_tpu_torch.parallel.comm import all_gather, all_reduce
    from nos_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, mesh_groups

    data = mesh_groups(mesh, ("dp", "sp"))
    tp, group = axis_size(mesh, "tp"), axis_group(mesh, "tp")
    out, grads = [], iter(grads)
    for layer in adapters["layers"]:
        for t, ab in layer.items():
            sliced = _tp_split(t)
            for key in ab:
                g = next(grads)
                if data:
                    g = all_reduce(g, data, kind="grad_sum")
                if tp > 1 and key == sliced[0]:
                    size = g.shape[sliced[1]] // tp
                    g = all_gather(g.narrow(sliced[1], axis_index(mesh, "tp") * size, size),
                                   group, sliced[1], kind="grad_sum")
                elif tp > 1:
                    g = all_reduce(g, [group], kind="grad_sum")
                out.append(g)
    return out


def make_lora_train_step(mesh, config, lora: LoraConfig, learning_rate: float = 1e-3,
                         optimizer=None, device=None):
    """Returns ``(train_step, shard_adapters)`` where
    ``train_step(adapter_state, base_params, tokens) -> (adapter_state,
    loss)``, ``loss`` a 0-d tensor on the device.

    Only the adapters take gradients and optimizer state; the base flows
    through as a constant and is never written. ``optimizer``: a factory
    ``params_list -> torch.optim.Optimizer`` (default ``torch.optim.Adam``
    at ``learning_rate``, the reference's ``optax.adam``), which then owns
    the hyperparameters. The step runs eagerly; with ``remat`` the
    per-layer checkpoint is non-reentrant, so adapter gradients survive a
    frozen embedding.

    ``mesh``: None for one device, or a ``DeviceMesh`` over ``dp`` /
    ``sp`` / ``tp`` (see the module note): ``base_params`` are the rank's
    shards (``sharding.shard_params``), ``tokens`` its ``[B/dp, S/sp]``
    block; the adapters and the optimizer state are whole on every rank
    and stay equal; every rank of the mesh calls together."""
    from nos_tpu_torch.models.llama import _check_mesh

    _check_mesh(mesh, config)
    if optimizer is not None and learning_rate != 1e-3:
        raise ValueError(
            "learning_rate configures the built-in Adam; an optimizer factory "
            "carries its own — set it there instead"
        )
    factory = optimizer or functools.partial(torch.optim.Adam, lr=learning_rate)
    dev = _resolve_device(device)

    def train_step(adapter_state, base_params, tokens):
        adapters, opt = adapter_state
        tokens = torch.as_tensor(tokens, device=dev)
        leaves = tree_leaves(adapters)
        attached = attach_lora(base_params, _rank_adapters(adapters, mesh), lora)
        loss = llama_loss(attached, tokens, config, mesh)
        grads = torch.autograd.grad(loss, leaves)
        if mesh is not None:
            grads = _whole_adapter_grads(grads, adapters, mesh)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return (adapters, opt), loss.detach()

    def shard_adapters(adapters: Params):
        """(adapters copied onto the device, taking gradients, and their
        optimizer); the caller's tensors stay untouched. Under a mesh
        every rank holds them whole (the same tree on every rank)."""
        adapters = tree_map(
            lambda p: p.detach().to(dev, copy=True).requires_grad_(True), adapters
        )
        return adapters, factory(tree_leaves(adapters))

    return train_step, shard_adapters
