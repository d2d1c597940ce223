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

Not in this slice: expert parallelism (a ``mesh`` raises, ROADMAP Queue
1 item 9, which also brings ``moe_param_sharding``).
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


def _route(flat: torch.Tensor, router: torch.Tensor, config: MoeConfig, tmask=None):
    """Routing of tokens ``flat`` [T, d] → (probs [T, E] f32, top_e
    [T, k], pair_w [P], pos [P], keep [P]) over the P = T·k (token,
    k-slot) pairs in token order: each pair's renormalised weight, its
    slot in its expert's buffer (clamped to cap - 1), and whether it won
    one. ``tmask`` [T] bool keeps masked tokens out of the race."""
    c = config
    t = flat.shape[0]
    cap = capacity_per_expert(t, c)
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
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos < cap
    if pair_mask is not None:
        keep = keep & pair_mask
    return probs, top_e, top_p.reshape(t * c.top_k), pos.clamp(max=cap - 1), keep


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
    """
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh is not ported yet "
            "(ROADMAP Queue 1 item 9: multi-device)"
        )
    c = config
    b, s, d = x.shape
    t = b * s
    flat = x.reshape(t, d)
    tmask = (None if token_mask is None
             else torch.as_tensor(token_mask, device=x.device).reshape(t))
    probs, top_e, pair_w, pos, keep = _route(flat, params["router"], c, tmask)
    pair_e = top_e.reshape(t * c.top_k)

    # ---- dispatch [E, C, d]. Dropped pairs land on slot cap-1 with a zero
    # contribution, beside the kept pair there: accumulate (exact, one
    # non-zero per slot), never an assignment, whose winner is unordered.
    token_idx = torch.arange(t, device=x.device).repeat_interleave(c.top_k)
    contrib = flat[token_idx] * keep[:, None].to(flat.dtype)
    dispatch = torch.zeros((c.n_experts, capacity_per_expert(t, c), d),
                           dtype=flat.dtype, device=x.device)
    dispatch = dispatch.index_put((pair_e, pos), contrib, accumulate=True)

    # ---- expert FFN over the stacked weights
    gate = _emm(dispatch, params["w_gate"])
    up = _emm(dispatch, params["w_up"])
    out_e = _emm(F.silu(gate) * up, params["w_down"])

    # ---- combine: gather each pair's expert output, weight, sum over k
    gathered = out_e[pair_e, pos]  # [P, d]
    weighted = gathered * (pair_w * keep).to(gathered.dtype)[:, None]
    out = weighted.reshape(t, c.top_k, d).sum(dim=1)
    out = out.reshape(b, s, d).to(x.dtype)
    if not return_aux:
        return out
    top1 = F.one_hot(top_e[:, 0], c.n_experts).float()
    if tmask is None:
        top1_frac = top1.mean(dim=0)
        mean_prob = probs.mean(dim=0)
    else:
        w = tmask.float()[:, None]
        denom = w.sum().clamp(min=1.0)
        top1_frac = (top1 * w).sum(dim=0) / denom
        mean_prob = (probs * w).sum(dim=0) / denom
    aux = c.n_experts * (top1_frac * mean_prob).sum()
    return out, aux
