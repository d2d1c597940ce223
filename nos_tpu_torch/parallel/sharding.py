"""Sharding rules for the Llama model over a mesh of ``dp``, ``sp``,
``tp``, ``ep`` and ``pp``.

Counterpart of ``nos_tpu/parallel/sharding.py`` and of
``nos_tpu/models/moe.py:moe_param_sharding``. The reference returns
``NamedSharding`` trees and XLA inserts the collectives; here a rule is
a spec, one entry a tensor dim (an axis name or None), and each rank
holds the block of every tensor its coordinates name (explicit SPMD).
The model writes the collectives out (``models/llama.py`` and
``models/moe.py`` with ``parallel/comm.py``).

- Megatron-style tensor parallelism: ``wq`` / ``wk`` / ``wv`` /
  ``w_gate`` / ``w_up`` shard their output columns over ``tp``, ``wo`` /
  ``w_down`` their input rows, so each attention and MLP block needs one
  all-reduce on the residual path. The embedding shards its vocabulary
  rows over ``tp`` and ``lm_head`` its vocabulary columns.
- FSDP: every 2-D weight also shards its other dim over ``dp``; the
  model gathers a layer's weights on use and reduce-scatters their
  gradients (``comm.fsdp_gather``). 1-D norm scales stay replicated.
- Experts (a MoE layer's ``moe`` node): the stacks [E, in, out] shard
  their expert dim over ``ep``, ``d_ff`` over ``tp`` and ``d_model``
  over ``dp`` (``w_gate`` / ``w_up`` ``(ep, dp, tp)``, ``w_down``
  ``(ep, tp, dp)``); an int8 stack's scales [E, out] follow its output
  dim. The f32 router is replicated.
- An axis the mesh lacks, or has at size 1, degrades to replication, so
  one rule tree serves every mesh shape. Every leaf outside the expert
  stacks is replicated over ``ep``; the pipeline's stacked layout
  prepends ``pp`` (``parallel/pipeline.py``).

The tp split of ``wq``'s columns keeps whole heads and whole GQA groups
(heads lie head-major in ``[d, H·hd]``) when tp divides both head
counts; any other tp raises ``ValueError``, as does an ep that does not
divide the expert count. Tokens ``[B, S]`` lie batch over ``dp`` and
sequence over ``sp`` (``llama_data_sharding``) and are the same on every
tp and ep rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nos_tpu_torch.parallel.comm import all_gather, fsdp_gather
from nos_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

Spec = Tuple[Optional[str], ...]

# The dense rules by params key (the reference's, leaf for leaf).
_COLUMN = ("dp", "tp")  # [in, out] with the output over tp
_ROW = ("tp", "dp")     # [in, out] with the input over tp
_DENSE_RULES = {
    "wq": _COLUMN, "wk": _COLUMN, "wv": _COLUMN, "w_gate": _COLUMN, "w_up": _COLUMN,
    "wo": _ROW, "w_down": _ROW, "embed": ("tp", "dp"), "lm_head": ("dp", "tp"),
}
# A MoE layer's expert stacks [E, in, out] (the reference's moe_param_sharding).
_MOE_RULES = {"router": (None, None), "w_gate": ("ep", "dp", "tp"),
              "w_up": ("ep", "dp", "tp"), "w_down": ("ep", "tp", "dp")}


def _block(x: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if x.shape[dim] % count:
        raise ValueError(
            f"dimension {dim} of {tuple(x.shape)} does not divide over {count} ranks"
        )
    size = x.shape[dim] // count
    return x.narrow(dim, index * size, size)


def sequence_block(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's ``S / sp`` columns of ``tokens`` [rows, S]."""
    return _block(tokens, 1, axis_index(mesh, "sp"), axis_size(mesh, "sp"))


def llama_data_sharding(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's ``[B / dp, S / sp]`` block of the global token batch
    ``tokens`` [B, S]: rows ``d·B/dp ...`` for dp index d, columns
    ``s·S/sp ...`` for sp index s (a view)."""
    rows = _block(tokens, 0, axis_index(mesh, "dp"), axis_size(mesh, "dp"))
    return sequence_block(mesh, rows)


# ------------------------------------------------------------- the rules


def check_tp_heads(config, tp: int) -> None:
    """tp must divide both head counts, so a rank's ``wq`` columns hold
    whole heads and whole GQA groups and its ``wk`` / ``wv`` columns the
    groups' kv heads."""
    if config.n_heads % tp or config.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={config.n_heads} and "
            f"n_kv_heads={config.n_kv_heads} (whole heads and GQA groups a rank)"
        )


def check_ep_experts(config, ep: int) -> None:
    """ep must divide the expert count, so a rank holds whole experts."""
    if config.n_experts % ep:
        raise ValueError(
            f"ep={ep} must divide n_experts={config.n_experts} (whole experts a rank)"
        )


def _degrade(spec: Spec, mesh) -> Spec:
    return tuple(a if a is not None and axis_size(mesh, a) > 1 else None for a in spec)


def _degraded(rule, mesh):
    """A rule (a spec, or a node of specs) with every axis the mesh lacks
    or has at size 1 replaced by None."""
    from nos_tpu_torch.models.llama import WeightNode

    if isinstance(rule, WeightNode):
        return rule.replace([_degrade(spec, mesh) for spec in rule.tensors()])
    return _degrade(rule, mesh)


def _quantized_rule(cls, in_axis, out_axis, group=None):
    """The specs of a quantized node's tensors, as a node of class
    ``cls`` holding specs: ``q`` shards like the dense weight, the scales
    along the output axis (int4's also along its groups, which tile the
    contraction axis; the embedding's along its vocabulary rows), so
    dequantization stays local."""
    from nos_tpu_torch.models.quantize import (
        QuantizedEmbedding,
        QuantizedLinear,
        QuantizedLinear4,
    )

    if cls is QuantizedLinear4:
        return QuantizedLinear4(q=(in_axis, None, out_axis), scale=(in_axis, out_axis),
                                group=group)
    if cls is QuantizedEmbedding:
        return QuantizedEmbedding(q=(in_axis, out_axis), scale=(in_axis,))
    if cls is QuantizedLinear:
        return QuantizedLinear(q=(in_axis, out_axis), scale=(out_axis,))
    raise NotImplementedError(
        f"a {cls.__name__} leaf has no sharding rule (the reference's rule trees "
        "have none for adapter nodes): shard the base, then attach the adapters"
    )


def leaf_rule(key: str, leaf) -> Any:
    """The undegraded rule of params leaf ``key`` (a dense tensor or a
    quantized node): a spec, or a node of specs."""
    if isinstance(leaf, torch.Tensor):
        return (None,) if leaf.dim() == 1 else _DENSE_RULES[key]
    return _quantized_rule(type(leaf), *_DENSE_RULES[key], getattr(leaf, "group", None))


def moe_leaf_rule(key: str, leaf) -> Any:
    """The undegraded rule of a ``moe`` node's leaf ``key``: the router's
    replication, a dense stack's spec, or an int8 stack's node of specs
    (``q`` like the dense stack, ``scale`` [E, out] along its experts and
    output dim)."""
    from nos_tpu_torch.models.quantize import QuantizedExpertStack

    rule = _MOE_RULES[key]
    if isinstance(leaf, torch.Tensor):
        return rule
    if isinstance(leaf, QuantizedExpertStack):
        return QuantizedExpertStack(q=rule, scale=(rule[0], rule[2]))
    raise NotImplementedError(f"a {type(leaf).__name__} expert stack has no sharding rule")


def moe_param_sharding(mesh, config) -> Dict[str, Any]:
    """The rule tree of a ``moe`` node (the reference's
    ``moe_param_sharding``): experts over ep, d_ff over tp, d_model over
    dp, the router replicated. ``config`` is a ``MoeConfig`` or a
    ``LlamaConfig``."""
    return {key: _degraded(rule, mesh) for key, rule in _MOE_RULES.items()}


def tree_rules(params, mesh) -> Dict[str, Any]:
    """The degraded rule tree of ``params`` itself (dense, int8 or int4
    leaves, MoE nodes alike), structured like it."""
    def walk(tree):
        out = {}
        for key, value in tree.items():
            if key == "layers":
                out[key] = [walk(layer) for layer in value]
            elif key == "moe":
                out[key] = {k: _degraded(moe_leaf_rule(k, v), mesh) for k, v in value.items()}
            else:
                out[key] = _degraded(leaf_rule(key, value), mesh)
        return out

    return walk(params)


_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_MLP_KEYS = ("w_gate", "w_up", "w_down")


def _config_rules(mesh, config, weight_rule, stack_rule=None) -> Dict[str, Any]:
    """The degraded rule tree of ``config``'s params: ``weight_rule(key)``
    for every weight, replication for the norms, and for a MoE model
    ``stack_rule(key)`` for every expert stack."""

    def rule(key):
        return _degraded((None,) if key.endswith("norm") else weight_rule(key), mesh)

    def layer():
        out = {key: rule(key) for key in _ATTN_KEYS}
        if config.n_experts > 0:
            out["moe"] = {"router": _degraded(_MOE_RULES["router"], mesh)}
            out["moe"].update({key: _degraded((stack_rule or _MOE_RULES.get)(key), mesh)
                               for key in _MLP_KEYS})
        else:
            out.update({key: rule(key) for key in _MLP_KEYS})
        return out

    tree = {
        "embed": rule("embed"),
        "final_norm": rule("final_norm"),
        "layers": [layer() for _ in range(config.n_layers)],
    }
    if not config.tie_embeddings:
        tree["lm_head"] = rule("lm_head")
    return tree


def llama_param_sharding(mesh, config) -> Dict[str, Any]:
    """The rule tree of a dense params tree: the reference's
    ``llama_param_sharding``, a spec in the place of each NamedSharding
    (a MoE layer's ``moe`` node by ``moe_param_sharding``)."""
    return _config_rules(mesh, config, lambda key: _DENSE_RULES[key])


def llama_quantized_sharding(mesh, config, bits: int = 8, group: int = 128) -> Dict[str, Any]:
    """The rule tree of ``quantize_params`` (bits 8) or
    ``quantize_params_int4`` (bits 4, the same ``group``) output: nodes
    of the quantized classes holding specs, as the reference's hold
    NamedShardings; expert stacks are int8 ``QuantizedExpertStack``
    nodes under either."""
    from nos_tpu_torch.models.quantize import (
        QuantizedEmbedding,
        QuantizedExpertStack,
        QuantizedLinear,
        QuantizedLinear4,
    )

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    linear = QuantizedLinear if bits == 8 else QuantizedLinear4

    def weight_rule(key):
        cls = QuantizedEmbedding if key == "embed" else linear
        return _quantized_rule(cls, *_DENSE_RULES[key], group)

    def stack_rule(key):
        rule = _MOE_RULES[key]
        return QuantizedExpertStack(q=rule, scale=(rule[0], rule[2]))

    return _config_rules(mesh, config, weight_rule, stack_rule)


def rule_leaves(rules) -> list:
    """The specs of a rule tree in ``tree_leaves`` order (a node's in its
    ``TENSORS`` order), one a params tensor."""
    from nos_tpu_torch.models.llama import WeightNode

    if isinstance(rules, tuple):
        return [rules]
    if isinstance(rules, WeightNode):
        return list(rules.tensors())
    if isinstance(rules, dict):
        return [spec for key in rules for spec in rule_leaves(rules[key])]
    return [spec for item in rules for spec in rule_leaves(item)]


# ------------------------------------------------- shards and their inverse


def _zip_map(fn, tree, rules):
    """``fn(tensor, spec)`` over a params tree and its rule tree."""
    from nos_tpu_torch.models.llama import WeightNode

    if isinstance(tree, torch.Tensor):
        return fn(tree, rules)
    if isinstance(tree, WeightNode):
        return tree.replace([fn(t, s) for t, s in zip(tree.tensors(), rules.tensors())])
    if isinstance(tree, dict):
        return {key: _zip_map(fn, tree[key], rules[key]) for key in tree}
    return type(tree)(_zip_map(fn, t, r) for t, r in zip(tree, rules))


def take_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor ``x`` under ``spec`` (a copy,
    so the whole tensor can go)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _block(x, dim, axis_index(mesh, axis), axis_size(mesh, axis))
    return x.contiguous().clone()


def gather_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (a
    collective: every rank of the mesh calls it), bit-exact."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(x, axis_group(mesh, axis), dim)
    return x


def param_rules(params, mesh, config) -> Dict[str, Any]:
    """The degraded rule tree of ``params`` on ``mesh``: dense, int8 or
    int4 (the group read off the tree), the shape ``shard_params`` and
    ``gather_params`` walk."""
    tp = axis_size(mesh, "tp")
    if tp > 1:
        check_tp_heads(config, tp)
    if config.n_experts > 0 and axis_size(mesh, "ep") > 1:
        check_ep_experts(config, axis_size(mesh, "ep"))
    return tree_rules(params, mesh)


def shard_params(params, mesh, config):
    """This rank's shards of a whole params tree (dense, int8 or int4),
    each a copy: what the rank holds under the reference's
    ``jax.device_put(params, llama_param_sharding(mesh, config))``."""
    rules = param_rules(params, mesh, config)
    return _zip_map(lambda x, spec: take_shard(x, spec, mesh), params, rules)


def gather_params(shards, mesh, config):
    """The whole tree from every rank's shards (the inverse of
    ``shard_params``; a collective, every rank of the mesh calls it)."""
    rules = param_rules(shards, mesh, config)
    return _zip_map(lambda x, spec: gather_shard(x, spec, mesh), shards, rules)


def unshard_dp(leaf, key: str, mesh, rule=None):
    """FSDP's gather on use: ``leaf`` (params key ``key``, a tensor or a
    quantized node; an adapted ``LoraLinear`` gathers its base) whole
    along ``dp``, still sharded over ``tp`` and ``ep``. ``rule``: the
    leaf's undegraded rule when it is not ``leaf_rule(key, leaf)`` (an
    expert stack's). The gradient of a gathered tensor reduce-scatters
    back over ``dp``. ``leaf`` itself when the mesh has no dp axis
    longer than 1."""
    from nos_tpu_torch.models.lora import LoraLinear

    group = axis_group(mesh, "dp")
    if group is None:
        return leaf

    def gather(x, spec):
        return fsdp_gather(x, group, spec.index("dp")) if "dp" in spec else x

    if isinstance(leaf, LoraLinear):
        return dataclasses.replace(leaf, w=unshard_dp(leaf.w, key, mesh))
    rule = leaf_rule(key, leaf) if rule is None else rule
    if isinstance(leaf, torch.Tensor):
        return gather(leaf, rule)
    return leaf.replace([gather(t, s) for t, s in zip(leaf.tensors(), rule.tensors())])
