"""Routed mixture-of-experts MLP, in PyTorch.

Counterpart of ``nos_tpu/models/moe.py``: top-k routing with a STATIC
per-expert capacity (overflow pairs are dropped, the Switch/GShard
discipline), dispatch into an ``[E, C, d]`` buffer, the expert FFNs as
one batched product per matrix over stacked weights, and a combine that
gathers each pair's expert output back. The reference is XLA einsums and
scatters, not a Pallas kernel, so this is plain PyTorch; the expert
products are ``torch.bmm``.

The rounding points are the reference's: routing in f32 (the router
stays f32), contributions and expert products in the model dtype, the
combine weights cast to the model dtype before the product and summed
over k in it. Ties in top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them (``torch.topk`` does not promise that):
a stable descending sort, then the first k.

Under a ``mesh`` (a ``DeviceMesh`` with axes among ``dp``, ``sp``,
``tp`` and ``ep``) each rank holds its ``[B/dp, S/sp]`` block of the
tokens, the same on every tp and ep rank, and its shards of the stacks
(``parallel/sharding.py:moe_param_sharding``). The reference's routing
is global: inside ``jit`` its capacity and its cumsum race run over the
global ``B·S`` tokens in row-major ``(b, s)`` order. So, here:

- The capacity comes from the global token count.
- The keep decision is global: a rank counts its unmasked pairs per
  expert per batch row, all-gathers those ``[B/dp, E]`` counts over the
  data ranks (sp, then dp) and adds the pairs that come before each of
  its rows in global order to its local exclusive cumsum. Masked pairs
  count nothing, as in the reference, so an idle or finished row claims
  no capacity on any rank.
- The buffer layout is the rank's own: its ``[E/ep, C, d]`` buffer holds
  only its pairs, at their global slots. The expert FFN is row-wise, so
  only the keep set must be the reference's; the slots of pairs on
  other data ranks stay zero rows.
- The Switch aux takes the global top-1 fractions and mean
  probabilities: the sums over the tokens are all-reduced over dp and sp
  and divided by the global (unmasked) count. Its value is the global
  one on every rank; its gradient is the rank's share, as ``llama_loss``
  gives its cross entropy's (the trainer sums the shares).
- ``ep``: every ep rank routes all its tokens (routing is the same on
  each), runs only its ``E/ep`` experts and gathers the expert outputs
  over ep (``comm.gather_from_group``, the rank's slice of the gradient
  back), so the combine is the one-device combine in the same order. The
  dispatched token rows pass ``comm.copy_to_group`` over ep: each rank's
  expert path gives part of their gradient, which the backward sums, so
  the gradient reaching attention is whole. The router path is
  replicated compute, whole on every rank: the router, attention and
  every leaf replicated over ep take no sum over ep, and the expert
  stacks only their dp sum.
- ``tp``: ``w_gate`` / ``w_up`` are column-parallel on ``d_ff`` and
  ``w_down`` row-parallel; one ``reduce_from_group`` over tp after
  ``w_down`` (before the ep gather), as the dense MLP does, and
  ``copy_to_group`` over tp on the dispatched rows.
- FSDP: under dp > 1 the stacks shard ``d_model`` over dp and are
  gathered on use (``sharding.unshard_dp``), their gradients
  reduce-scattered back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class MoeConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def capacity_per_expert(n_tokens: int, config: MoeConfig) -> int:
    """Static buffer depth per expert: ceil(k·T/E · factor), min 1."""
    c = config
    return max(1, math.ceil(c.top_k * n_tokens / c.n_experts * c.capacity_factor))


def init_moe_params(generator: torch.Generator, config: MoeConfig) -> Params:
    """Random router and expert stacks drawn from ``generator`` on its
    device, one tensor at a time (f32 normal / sqrt(fan_in)); the router
    stays f32, the stacks take the model dtype."""
    c = config
    dev = generator.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in))

    return {
        "router": normal((c.d_model, c.n_experts), c.d_model),
        "w_gate": normal((c.n_experts, c.d_model, c.d_ff), c.d_model).to(c.dtype),
        "w_up": normal((c.n_experts, c.d_model, c.d_ff), c.d_model).to(c.dtype),
        "w_down": normal((c.n_experts, c.d_ff, c.d_model), c.d_ff).to(c.dtype),
    }


def _emm(x: torch.Tensor, w) -> torch.Tensor:
    """Batched expert product [E, C, in] x [E, in, out]: a dense stack,
    or a node with its own ``expert_matmul`` (QuantizedExpertStack)."""
    if isinstance(w, torch.Tensor):
        return torch.bmm(x, w)
    return w.expert_matmul(x)


def _data_ranks(mesh) -> int:
    """The data ranks a MoE call's race spans: dp · sp (1 without a mesh)."""
    from nos_tpu_torch.parallel.mesh import axis_size

    return axis_size(mesh, "dp") * axis_size(mesh, "sp")


def _earlier_pairs(counts: torch.Tensor, mesh) -> torch.Tensor:
    """counts [rows, E], this rank's unmasked pairs per expert in each of
    its batch rows → [rows, E], the pairs of each expert that come before
    each row's in the global row-major order: every rank's counts
    gathered over sp, then dp, and summed exclusively."""
    from nos_tpu_torch.parallel.comm import all_gather
    from nos_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    rows, e = counts.shape
    grid = counts[:, None, :]  # [rows, sp, E] once gathered
    for axis, dim in (("sp", 1), ("dp", 0)):
        if axis_size(mesh, axis) > 1:
            grid = all_gather(grid, axis_group(mesh, axis), dim, kind="ep")
    flat = grid.reshape(-1, e)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(grid.shape)
    d, q = axis_index(mesh, "dp"), axis_index(mesh, "sp")
    return before[d * rows:(d + 1) * rows, q]


def _route(flat: torch.Tensor, router: torch.Tensor, config: MoeConfig, tmask=None,
           mesh=None, rows: int = 1):
    """Routing of tokens ``flat`` [T, d] → (probs [T, E] f32, top_e
    [T, k], pair_w [P], pos [P], keep [P]) over the P = T·k (token,
    k-slot) pairs in token order: each pair's renormalised weight, its
    slot in its expert's buffer (clamped to cap - 1), and whether it won
    one. ``tmask`` [T] bool keeps masked tokens out of the race. Under a
    ``mesh`` with data ranks, ``flat`` is the rank's block of ``rows``
    batch rows and the capacity and race are the global batch's."""
    c = config
    t = flat.shape[0]
    cap = capacity_per_expert(t * _data_ranks(mesh), c)
    probs = torch.softmax(flat.float() @ router, dim=-1)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = sorted_p[:, :c.top_k], sorted_e[:, :c.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    pair_e = top_e.reshape(t * c.top_k)
    onehot = F.one_hot(pair_e, c.n_experts)  # [P, E] int64
    pair_mask = None if tmask is None else tmask.repeat_interleave(c.top_k)
    if pair_mask is not None:
        # a masked pair advances no expert's running count
        onehot = onehot * pair_mask[:, None]
    per_row = onehot.reshape(rows, -1, c.n_experts)
    within = torch.cumsum(per_row, dim=1) - per_row  # exclusive, in the row
    before = _earlier_pairs(per_row.sum(dim=1), mesh)
    pos = ((within + before[:, None, :]) * per_row).sum(dim=-1).reshape(-1)
    keep = pos < cap
    if pair_mask is not None:
        keep = keep & pair_mask
    return probs, top_e, top_p.reshape(t * c.top_k), pos.clamp(max=cap - 1), keep


def _stack(params: Params, key: str, mesh):
    """Expert stack ``key`` as this rank multiplies by it: whole along
    ``dp`` (FSDP's gather on use), still sharded over ``ep`` and ``tp``."""
    if mesh is None:
        return params[key]
    from nos_tpu_torch.parallel.sharding import moe_leaf_rule, unshard_dp

    return unshard_dp(params[key], key, mesh, rule=moe_leaf_rule(key, params[key]))


def _aux(probs, top_e, tmask, config: MoeConfig, mesh):
    """The Switch balance loss ``E · Σ_e f_e · P_e``. Under a mesh with
    data ranks the token sums are all-reduced over dp and sp: the global
    value on every rank, the rank's share of the gradient."""
    from nos_tpu_torch.parallel.comm import all_reduce
    from nos_tpu_torch.parallel.mesh import mesh_groups

    c = config
    e = c.n_experts
    top1 = F.one_hot(top_e[:, 0], e).float()
    w = torch.ones_like(probs[:, :1]) if tmask is None else tmask.float()[:, None]
    prob_sum = (probs * w).sum(dim=0)
    stats = torch.cat([(top1 * w).sum(dim=0), prob_sum.detach(), w.sum()[None]])
    groups = mesh_groups(mesh, ("dp", "sp"))
    if groups:
        stats = all_reduce(stats, groups, kind="ep")
    denom = stats[2 * e].clamp(min=1.0)
    # the global sum's value, this rank's gradient
    prob_sum = stats[e:2 * e] + (prob_sum - prob_sum.detach())
    return e * (stats[:e] / denom * (prob_sum / denom)).sum()


def moe_mlp(
    params: Params,
    x: torch.Tensor,
    config: MoeConfig,
    mesh=None,
    return_aux: bool = False,
    token_mask: Optional[torch.Tensor] = None,
):
    """x [B, S, d] → [B, S, d] through top-k routed experts.

    ``return_aux`` also returns the Switch load-balancing loss
    ``E · Σ_e f_e · P_e`` (top-1 dispatch fraction times mean router
    probability per expert), a 0-d f32 tensor.

    ``token_mask`` [B, S] excludes tokens entirely: masked tokens claim
    no expert capacity, output zero and stay out of the aux statistics.

    ``mesh``: a ``DeviceMesh`` over ``dp`` / ``sp`` / ``tp`` / ``ep``
    (see the module note); ``x`` is the rank's ``[B/dp, S/sp, d]`` block
    and ``params`` its shards; every rank of the mesh calls together.
    """
    from nos_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    _check_moe_mesh(mesh, config)
    c = config
    b, s, d = x.shape
    t = b * s
    flat = x.reshape(t, d)
    tmask = (None if token_mask is None
             else torch.as_tensor(token_mask, device=x.device).reshape(t))
    probs, top_e, pair_w, pos, keep = _route(flat, params["router"], c, tmask, mesh, b)
    pair_e = top_e.reshape(t * c.top_k)
    cap = capacity_per_expert(t * _data_ranks(mesh), c)

    # ---- dispatch [E/ep, C, d] of this rank's experts. Dropped pairs
    # (and under ep the other ranks' pairs) add a zero contribution at a
    # slot of their own or beside a kept pair: accumulate (exact, one
    # non-zero per slot), never an assignment, whose winner is unordered.
    ep = axis_size(mesh, "ep")
    local = c.n_experts // ep
    first = axis_index(mesh, "ep") * local
    tp_group, ep_group = axis_group(mesh, "tp"), axis_group(mesh, "ep")
    if mesh is not None:
        from nos_tpu_torch.parallel.comm import copy_to_group

        # each tp / ep rank's experts give part of these rows' gradient
        flat_e = copy_to_group(copy_to_group(flat, tp_group), ep_group, kind="ep")
    else:
        flat_e = flat
    mine = keep if ep == 1 else keep & (pair_e >= first) & (pair_e < first + local)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(c.top_k)
    contrib = flat_e[token_idx] * mine[:, None].to(flat.dtype)
    dispatch = torch.zeros((local, cap, d), dtype=flat.dtype, device=x.device)
    dispatch = dispatch.index_put(((pair_e - first).clamp(0, local - 1), pos), contrib,
                                  accumulate=True)

    # ---- expert FFN over the stacked weights (this rank's experts and
    # d_ff columns), summed over tp, gathered over ep
    gate = _emm(dispatch, _stack(params, "w_gate", mesh))
    up = _emm(dispatch, _stack(params, "w_up", mesh))
    out_e = _emm(F.silu(gate) * up, _stack(params, "w_down", mesh))
    if mesh is not None:
        from nos_tpu_torch.parallel.comm import gather_from_group, reduce_from_group

        out_e = gather_from_group(reduce_from_group(out_e, tp_group), ep_group, dim=0,
                                  kind="ep")

    # ---- combine: gather each pair's expert output, weight, sum over k
    gathered = out_e[pair_e, pos]  # [P, d]
    weighted = gathered * (pair_w * keep).to(gathered.dtype)[:, None]
    out = weighted.reshape(t, c.top_k, d).sum(dim=1)
    out = out.reshape(b, s, d).to(x.dtype)
    if not return_aux:
        return out
    return out, _aux(probs, top_e, tmask, c, mesh)


def _check_moe_mesh(mesh, config) -> None:
    """None, or a ``DeviceMesh`` over dp / sp / tp / ep whose ep divides
    the expert count."""
    if mesh is None:
        return
    from nos_tpu_torch.parallel.mesh import axis_size, check_mesh_axes
    from nos_tpu_torch.parallel.sharding import check_ep_experts

    check_mesh_axes(mesh, allowed=("dp", "sp", "tp", "ep"))
    check_ep_experts(config, axis_size(mesh, "ep"))
