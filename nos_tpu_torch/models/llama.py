"""Llama-style decoder-only transformer in PyTorch.

Counterpart of ``nos_tpu/models/llama.py``, with the same parameter
layout (a dict: ``embed`` [V, D], ``final_norm``, optional ``lm_head``
[D, V], ``layers[i]`` holding ``[in, out]`` matrices) so weights bridge
from the reference unchanged (``nos_tpu_torch.bridge``). The dtype
rounding points are the reference's: RoPE tables computed in f32 then
cast to the model dtype, the plain RMSNorm downcasting before its weight
(the Gemma offset form staying f32), a model-dtype ``embed_scale``,
attention probabilities cast to the input dtype before PV, and logits
unembedded in the model dtype then cast to f32.

``attention="flash"`` runs the hand-written Hopper kernel on a CUDA
tensor and its plain version on a CPU one (``nos_tpu_torch.ops``).

``llama_loss`` is the training objective; gradients of the flash branch
run the hand-written backward kernels (``nos_tpu_torch.ops``).

A weight leaf is a dense tensor or a ``WeightNode``: a quantized weight
(``models/quantize.py``) or an adapted one (``models/lora.py``). ``_mm``
and ``_embed_rows`` dispatch on it, so no model code forks.

``n_experts > 0`` swaps every MLP for a routed mixture-of-experts
(``models/moe.py``): the layer holds a ``moe`` dict (f32 router, stacked
expert weights), the block returns its balance loss beside x, and
``llama_loss`` adds ``moe_aux_coef`` times its mean over the layers.

A ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` with axes among
``dp``, ``sp``, ``tp`` and ``ep``: explicit SPMD, each rank running the model
on its own ``[B/dp, S/sp]`` block of tokens
(``parallel/sharding.py:llama_data_sharding``) with its own shards of
the params (``parallel/sharding.py:shard_params``; under a mesh whose
``dp`` and ``tp`` are 1 that is the whole tree).

- ``tp``: Megatron-style. A rank holds ``n_heads/tp`` query and
  ``n_kv_heads/tp`` kv heads' columns of ``wq`` / ``wk`` / ``wv`` and
  ``d_ff/tp`` of ``w_gate`` / ``w_up``, and the matching rows of ``wo``
  / ``w_down``; ``copy_to_group`` goes before the column-parallel
  products and one ``reduce_from_group`` after ``wo`` and after
  ``w_down`` (``parallel/comm.py``). The embedding is vocab-parallel (a
  masked lookup in the rank's rows, then an all-reduce) and so is the
  unembedding: ``llama_forward`` gathers the logits whole,
  ``llama_loss`` reduces the max, the sum of exponentials and the
  target logit over ``tp`` instead.
- ``dp``: FSDP. The 2-D weights are also sharded over dp; each layer's
  are gathered on use and their gradients reduce-scattered
  (``sharding.unshard_dp``), so under remat a rank holds one layer's
  gathered weights at a time.
- ``sp``: RoPE takes global positions (the rank's offset is ``sp index
  · S/sp``); attention runs sequence-parallel on the rank's heads per
  ``sp_strategy`` and ``attention`` (``parallel/ring_attention.py``,
  ``parallel/ulysses.py``); ``llama_loss`` passes each shard's next
  token across the ring and averages over the global token count.

- ``ep``: the tokens and every leaf but the expert stacks are
  replicated over ep; a MoE layer runs ``moe_mlp`` over the mesh
  (``models/moe.py``: the global capacity race over dp and sp, the
  rank's experts, their outputs gathered over ep). A dense model
  replicates over ep.

tp must divide both head counts and ep the expert count
(``ValueError``; Gemma-2B's one kv head rules tp > 1 out). A ``pp``
axis longer than 1 belongs to ``parallel/pipeline.py`` (``ValueError``
here); a mesh that is not a ``DeviceMesh`` raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.moe import MoeConfig, init_moe_params, moe_mlp

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    # ("llama3", factor, low_freq_factor, high_freq_factor,
    #  original_max_position_embeddings); None = plain RoPE.
    rope_scaling: Any = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "dense" (torch einsums) or "flash" (the hand-written kernel).
    attention: str = "dense"
    # Per-layer activation checkpointing when gradients are taken.
    remat: bool = False
    # Mistral-style sliding window: each query attends only the last
    # `sliding_window` positions. None = full causal attention.
    sliding_window: Any = None
    # Sequence-parallel strategy under a mesh with sp > 1: "ring" (K/V
    # blocks passed around the sp ranks) or "ulysses" (all-to-all head
    # scatter / sequence gather; head counts must divide by sp).
    sp_strategy: str = "ring"
    # Gemma dialect: "silu" or "gelu" (tanh form) gated MLP.
    hidden_act: str = "silu"
    # RMSNorm multiplies by (1 + w) in f32 when True, by w when False.
    norm_offset: bool = False
    # Multiply embeddings by sqrt(d_model) after lookup.
    scale_embeddings: bool = False
    # Unembed with the input embedding (params carry no lm_head).
    tie_embeddings: bool = False
    # Explicit head dim when it differs from d_model / n_heads.
    qk_head_dim: Any = None
    # n_experts > 0: every MLP is a routed mixture-of-experts (moe.py).
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # Weight of the Switch load-balancing loss in llama_loss.
    moe_aux_coef: float = 0.01

    def moe_config(self) -> MoeConfig:
        return MoeConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            n_experts=self.n_experts,
            top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
            dtype=self.dtype,
        )

    @property
    def head_dim(self) -> int:
        if self.qk_head_dim is not None:
            return int(self.qk_head_dim)
        return self.d_model // self.n_heads

    @property
    def embed_scale(self):
        """Post-lookup embedding multiplier, or None: sqrt(d_model)
        rounded to the model dtype (as the reference implementations
        cast the scalar before multiplying). A CPU scalar tensor: it
        broadcasts onto any device."""
        if not self.scale_embeddings:
            return None
        return torch.tensor(math.sqrt(self.d_model), dtype=self.dtype)


def tiny_config(**overrides) -> LlamaConfig:
    """Small config for tests and dry runs."""
    defaults = dict(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=8,
        n_kv_heads=8,
        d_ff=128,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def llama_3_8b_config() -> LlamaConfig:
    return LlamaConfig()


def gemma_2b_config() -> LlamaConfig:
    """Gemma-2B: gelu gated MLP, (1 + w) RMSNorm, sqrt(d_model)-scaled
    embeddings, tied unembedding, MQA and a 256 head dim."""
    return LlamaConfig(
        vocab_size=256000,
        d_model=2048,
        n_layers=18,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        rope_theta=10000.0,
        norm_eps=1e-6,
        hidden_act="gelu",
        norm_offset=True,
        scale_embeddings=True,
        tie_embeddings=True,
        qk_head_dim=256,
    )


def _check_mesh(mesh, config: "LlamaConfig") -> None:
    """None, or a mesh the model runs: a ``DeviceMesh`` whose axes are
    among ``dp``, ``sp``, ``tp``, ``ep`` and ``pp``, with tp dividing both
    head counts and ep the expert count. A ``pp`` axis longer than 1
    belongs to the pipeline's entry points (``parallel/pipeline.py``):
    the reference would replicate over it under XLA, a global view the
    port's ranks do not have. Anything else is a loud error."""
    if mesh is None:
        return
    from nos_tpu_torch.parallel.mesh import axis_size, check_mesh_axes

    check_mesh_axes(mesh)
    if axis_size(mesh, "pp") > 1:
        raise ValueError(
            "a mesh with pp > 1 runs the pipeline: call "
            "parallel.pipeline.pipeline_llama_forward / pipeline_llama_loss"
        )
    from nos_tpu_torch.parallel.sharding import check_ep_experts, check_tp_heads

    if axis_size(mesh, "tp") > 1:
        check_tp_heads(config, axis_size(mesh, "tp"))
    if config.n_experts > 0 and axis_size(mesh, "ep") > 1:
        check_ep_experts(config, axis_size(mesh, "ep"))


# ------------------------------------------------------------------- init


def init_llama_params(config: LlamaConfig, seed: int = 0, device=None) -> Params:
    """Random weights drawn on ``device`` from a seeded generator, one
    tensor at a time (f32 normal / sqrt(fan_in), cast to the model
    dtype): a full-size model never exists in f32 or on the host. Not
    the reference's numbers (``jax.random`` has no torch twin): to hold
    the port against the reference, bridge its weights instead."""
    c = config
    dev = _resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in)).to(c.dtype)

    def norm():
        fill = 0.0 if c.norm_offset else 1.0
        return torch.full((c.d_model,), fill, dtype=c.dtype, device=dev)

    hd = c.head_dim
    params: Params = {
        "embed": dense((c.vocab_size, c.d_model), c.d_model),
        "final_norm": norm(),
        "layers": [],
    }
    if not c.tie_embeddings:
        params["lm_head"] = dense((c.d_model, c.vocab_size), c.d_model)
    for _ in range(c.n_layers):
        layer = {
            "attn_norm": norm(),
            "wq": dense((c.d_model, c.n_heads * hd), c.d_model),
            "wk": dense((c.d_model, c.n_kv_heads * hd), c.d_model),
            "wv": dense((c.d_model, c.n_kv_heads * hd), c.d_model),
            "wo": dense((c.n_heads * hd, c.d_model), c.n_heads * hd),
            "mlp_norm": norm(),
        }
        if c.n_experts > 0:
            layer["moe"] = init_moe_params(gen, c.moe_config())
        else:
            layer["w_gate"] = dense((c.d_model, c.d_ff), c.d_model)
            layer["w_up"] = dense((c.d_model, c.d_ff), c.d_model)
            layer["w_down"] = dense((c.d_ff, c.d_model), c.d_ff)
        params["layers"].append(layer)
    return params


class WeightNode:
    """A params leaf holding several tensors: a quantized weight
    (``models/quantize.py``) or an adapted one (``models/lora.py``), the
    port's form of the reference's pytree node classes. Subclasses are
    dataclasses naming their tensor fields in ``TENSORS``; every other
    field (an int4 group, a LoRA scale) is static."""

    TENSORS: Tuple[str, ...] = ()

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, name) for name in self.TENSORS]

    def replace(self, tensors) -> "WeightNode":
        """The same node over new tensors, in ``TENSORS`` order."""
        return dataclasses.replace(self, **dict(zip(self.TENSORS, tensors)))

    def to(self, device) -> "WeightNode":
        return self.replace([t.to(device) for t in self.tensors()])


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of a params-shaped tree, where a leaf is a
    tensor or a whole ``WeightNode``; same structure."""
    if isinstance(tree, (torch.Tensor, WeightNode)):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: map_leaves(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, item) for item in tree)
    raise TypeError(f"params tree holds a {type(tree).__name__}")


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a params-shaped tree (dicts in key order, lists in
    order, a node's tensors in its ``TENSORS`` order): one fixed order
    for params, gradients and velocity."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, WeightNode):
        return tree.tensors()
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    raise TypeError(f"params tree holds a {type(tree).__name__}")


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a params-shaped tree, same structure
    (a node is rebuilt over the mapped tensors)."""
    def leaf(x):
        return fn(x) if isinstance(x, torch.Tensor) else x.replace(map(fn, x.tensors()))

    return map_leaves(leaf, tree)


def params_device(params: Params) -> torch.device:
    return tree_leaves(params["embed"])[0].device


# ---------------------------------------------------------------- forward


def _tp_group(mesh):
    """The rank's tp group, or None (no mesh, or tp of size 1)."""
    if mesh is None:
        return None
    from nos_tpu_torch.parallel.mesh import axis_group

    return axis_group(mesh, "tp")


def _copy_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """``comm.copy_to_group`` over the rank's tp group, before a
    column-parallel product (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    from nos_tpu_torch.parallel.comm import copy_to_group

    return copy_to_group(x, _tp_group(mesh))


def _reduce_out(x: torch.Tensor, mesh) -> torch.Tensor:
    """``comm.reduce_from_group`` over the rank's tp group, after a
    row-parallel product (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    from nos_tpu_torch.parallel.comm import reduce_from_group

    return reduce_from_group(x, _tp_group(mesh))


def _w(tree: Params, key: str, mesh=None):
    """Weight ``key`` of a layer (or of the params' top level) as this
    rank multiplies by it: whole along ``dp`` (FSDP's gather on use),
    still sharded over ``tp``."""
    if mesh is None:
        return tree[key]
    from nos_tpu_torch.parallel.sharding import unshard_dp

    return unshard_dp(tree[key], key, mesh)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w, dispatching on the weight leaf: a dense tensor, or a node
    with its own ``matmul`` (QuantizedLinear, QuantizedLinear4,
    LoraLinear, MultiLoraLinear)."""
    if isinstance(w, torch.Tensor):
        return x @ w
    return w.matmul(x)


def _embed_rows(embed, tokens: torch.Tensor, dtype, scale=None) -> torch.Tensor:
    # Advanced indexing wraps negative ids (the engine's pad id -1) the
    # way the reference's gather does; those rows are masked everywhere.
    if isinstance(embed, torch.Tensor):
        rows = embed[tokens]
    else:  # QuantizedEmbedding: only the looked-up rows widen
        rows = embed.lookup(tokens, dtype)
    if scale is not None:
        rows = rows * scale.to(rows.device)
    return rows


def _embed(params: Params, tokens: torch.Tensor, c: "LlamaConfig", mesh=None) -> torch.Tensor:
    """Embedding rows of ``tokens``. Under tp the table's vocab rows are
    sharded: each rank looks up the ids inside its rows (zero rows
    elsewhere) and the ranks' rows sum over tp. Negative ids wrap as the
    single-device lookup wraps them."""
    embed = _w(params, "embed", mesh)
    if _tp_group(mesh) is None:
        return _embed_rows(embed, tokens, c.dtype, c.embed_scale)
    from nos_tpu_torch.parallel.mesh import axis_index

    rows = tree_leaves(embed)[0].shape[0]
    local = torch.remainder(tokens, c.vocab_size) - axis_index(mesh, "tp") * rows
    inside = (local >= 0) & (local < rows)
    x = _embed_rows(embed, torch.where(inside, local, 0), c.dtype, c.embed_scale)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _reduce_out(x, mesh)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, offset: bool = False):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if offset:
        # (1 + w) in f32: in bf16 small weights would quantize away.
        return ((x32 * rms) * (weight.float() + 1.0)).to(x.dtype)
    return (x32 * rms).to(x.dtype) * weight


def _unembed_weight(params: Params, mesh=None):
    """The [d_model, vocab] unembedding operand for ``_mm`` (the rank's
    vocab columns under tp); tied models reuse the embedding. A
    quantized tied embedding transposes into the QuantizedLinear layout
    (per-vocab-row scales become per-output-column scales), so int8
    logits never materialize a dequantized table."""
    if "lm_head" in params:
        return _w(params, "lm_head", mesh)
    embed = _w(params, "embed", mesh)
    if isinstance(embed, torch.Tensor):
        return embed.T
    return embed.as_unembedding()


def _unembed(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Vocab logits in the model dtype, the rank's vocab shard under tp;
    tied models reuse the embedding."""
    return _mm(_copy_in(x, mesh), _unembed_weight(params, mesh))


def _logits(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Whole-vocab f32 logits: under tp the ranks' shards gathered, so
    every rank holds the same bytes."""
    logits = _unembed(params, x, mesh)
    if mesh is not None:
        from nos_tpu_torch.parallel.comm import gather_from_group

        logits = gather_from_group(logits, _tp_group(mesh))
    return logits.float()


def _llama3_scaled_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """The Llama-3.1 frequency transform: long wavelengths divide by
    ``factor``, short ones stay, the middle band interpolates."""
    _, factor, low_ff, high_ff, orig_max = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wavelen = orig_max / low_ff
    high_wavelen = orig_max / high_ff
    smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
    mid = (1.0 - smooth) * freqs / factor + smooth * freqs
    out = torch.where(wavelen > low_wavelen, freqs / factor, mid)
    return torch.where(wavelen < high_wavelen, freqs, out)


def _rope_at(positions: torch.Tensor, head_dim: int, theta: float, dtype, scaling=None):
    """(cos, sin) tables for positions [P] → each [P, hd/2], computed in
    f32 and cast to ``dtype``."""
    dev = positions.device
    freqs = theta ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    )
    if scaling is not None:
        freqs = _llama3_scaled_freqs(freqs, scaling)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rope(seq_len: int, head_dim: int, theta: float, dtype, scaling=None, device=None):
    return _rope_at(
        torch.arange(seq_len, device=device), head_dim, theta, dtype, scaling
    )


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd] rotated half-and-half (not interleaved) by tables
    of rank 2 ([S, hd/2], shared across the batch) or rank 4 (already
    broadcast). Every path calls this one formula."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _window_causal_mask(s: int, sliding_window, device=None) -> torch.Tensor:
    """THE causal mask [s, s]: lower-triangular, banded to the last
    ``sliding_window`` positions when set."""
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
    if sliding_window is not None:
        pos = torch.arange(s, device=device)
        causal = causal & (pos[:, None] - pos[None, :] < sliding_window)
    return causal


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """q [B, S, Hq, hd] · k [B, T, Hkv, hd] → f32 [B, Hkv, G, S, T]
    (bf16 products are exact in f32: f32 accumulation of bf16 operands)."""
    b, s, hq, hd = q.shape
    qg = q.reshape(b, s, n_kv_heads, hq // n_kv_heads, hd)
    return torch.einsum("bsKgh,btKh->bKgst", qg.float(), k.float())


def _grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B, Hkv, G, S, T] (already in the value dtype) · v → [B, S,
    Hq*hd] in that dtype, accumulated in f32."""
    b, hkv, g, s, _ = probs.shape
    out = torch.einsum("bKgst,btKh->bsKgh", probs.float(), v.float())
    return out.reshape(b, s, hkv * g * v.shape[-1]).to(probs.dtype)


def gqa_dense_attention(q, k, v, mask=None) -> torch.Tensor:
    """Grouped-query dense attention, q [B,S,Hq,hd], k/v [B,S,Hkv,hd] →
    [B,S,Hq,hd]. ``mask`` is a [Sq,Skv] bool (True = attend)."""
    b, s, hq, hd = q.shape
    scores = _grouped_scores(q, k, k.shape[2]) / math.sqrt(hd)
    if mask is not None:
        # -1e30, not -inf: a fully masked row softmaxes finite, not NaN
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_values(probs, v).reshape(b, s, hq, hd)


def _qkv(h: torch.Tensor, layer: Params, c: LlamaConfig, mesh=None):
    """q [B, S, Hq, hd], k / v [B, S, Hkv, hd]: the rank's Hq/tp and
    Hkv/tp heads under tp (the column-parallel products)."""
    b, s, _ = h.shape
    hd = c.head_dim
    h = _copy_in(h, mesh)
    q = _mm(h, _w(layer, "wq", mesh)).reshape(b, s, -1, hd)
    k = _mm(h, _w(layer, "wk", mesh)).reshape(b, s, -1, hd)
    v = _mm(h, _w(layer, "wv", mesh)).reshape(b, s, -1, hd)
    return q, k, v


def _attn_out(attn: torch.Tensor, layer: Params, mesh=None) -> torch.Tensor:
    """attn [B, S, Hq·hd] (the rank's heads) @ wo, summed over tp (the
    row-parallel product)."""
    return _reduce_out(_mm(attn, _w(layer, "wo", mesh)), mesh)


def _sp_attention(q, k, v, c: LlamaConfig, mesh) -> torch.Tensor:
    """Sequence-parallel attention of the rank's blocks → [B, S/sp,
    Hq*hd]: the ring (flash kernels in block mode, or the plain ring) or
    Ulysses (the kernels or the einsum on the gathered sequence)."""
    if c.sp_strategy == "ulysses":
        from nos_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, mesh, causal=True, attention=c.attention,
                                 window=c.sliding_window)
    if c.sp_strategy != "ring":
        raise ValueError(
            f"unknown sp_strategy {c.sp_strategy!r}; expected 'ring' or 'ulysses'"
        )
    from nos_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
    )

    ring = ring_flash_attention if c.attention == "flash" else ring_attention
    return ring(q, k, v, mesh, causal=True, window=c.sliding_window)


def _attention(x, layer: Params, config: LlamaConfig, cos, sin, mesh=None) -> torch.Tensor:
    c = config
    b, s, _ = x.shape
    q, k, v = _qkv(x, layer, c, mesh)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    from nos_tpu_torch.parallel.mesh import axis_size

    if axis_size(mesh, "sp") > 1:
        return _attn_out(_sp_attention(q, k, v, c, mesh), layer, mesh)
    if c.attention == "flash":
        from nos_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, causal=True, window=c.sliding_window)
    else:
        out = gqa_dense_attention(
            q, k, v, _window_causal_mask(s, c.sliding_window, x.device)
        )
    return _attn_out(out.reshape(b, s, -1), layer, mesh)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {act!r}")


def _mlp(x: torch.Tensor, layer: Params, act: str = "silu", mesh=None) -> torch.Tensor:
    """The gated MLP: column-parallel gate / up, row-parallel down,
    summed over tp."""
    x = _copy_in(x, mesh)
    gate = _act(_mm(x, _w(layer, "w_gate", mesh)), act)
    return _reduce_out(_mm(gate * _mm(x, _w(layer, "w_up", mesh)), _w(layer, "w_down", mesh)),
                       mesh)


def llama_forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                  mesh=None, with_aux: bool = False):
    """tokens [B, S] int → logits [B, S, vocab] (float32). ``with_aux``
    also returns the MoE load-balancing loss summed over the layers (a
    0-d f32 tensor, zero for a dense model). With ``remat`` and gradients
    on, each block is checkpointed and recomputed (flash kernel and
    collectives included) in the backward.

    Under a ``mesh`` (see the module docstring) ``params`` are the rank's
    shards, ``tokens`` is this rank's ``[B/dp, S/sp]`` block and the
    logits are the block's, whole over the vocabulary; every rank of the
    mesh calls it together."""
    x, aux = _decoder(params, tokens, config, mesh, with_aux)
    logits = _logits(params, x, mesh)
    if with_aux:
        return logits, aux
    return logits


def _decoder(params: Params, tokens: torch.Tensor, config: LlamaConfig, mesh,
             with_aux: bool):
    """The blocks and the final norm → (x [B, S, D], the summed MoE aux)."""
    c = config
    _check_mesh(mesh, c)
    from nos_tpu_torch.parallel.mesh import axis_index

    tokens = tokens.to(params_device(params))
    x = _embed(params, tokens, c, mesh)
    s = tokens.shape[1]
    start = axis_index(mesh, "sp") * s  # global positions of the block
    cos, sin = _rope_at(torch.arange(start, start + s, device=x.device),
                        c.head_dim, c.rope_theta, c.dtype, c.rope_scaling)

    def block(x, layer):
        x = x + _attention(
            _rms_norm(x, layer["attn_norm"], c.norm_eps, c.norm_offset),
            layer, c, cos, sin, mesh,
        )
        h = _rms_norm(x, layer["mlp_norm"], c.norm_eps, c.norm_offset)
        if "moe" not in layer:
            return x + _mlp(h, layer, c.hidden_act, mesh), None
        if with_aux:
            delta, aux = moe_mlp(layer["moe"], h, c.moe_config(), mesh, return_aux=True)
            return x + delta, aux
        return x + moe_mlp(layer["moe"], h, c.moe_config(), mesh), None

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if c.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x, aux = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x, aux = block(x, layer)
        if aux is not None:
            aux_total = aux_total + aux
    return _rms_norm(x, params["final_norm"], c.norm_eps, c.norm_offset), aux_total


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL as logsumexp(logits) - logits[target]."""
    targets = tokens[:, 1:].to(logits.device).long()
    logits_t = logits[:, :-1]
    lse = torch.logsumexp(logits_t, dim=-1)
    picked = torch.gather(logits_t, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                        mesh) -> torch.Tensor:
    """logsumexp(logits) − logits[target] per position, from the rank's
    vocab shard of the logits [B, S, V/tp] under tp: the max, the sum of
    exponentials and the target logit reduce over tp, so the whole
    [B, S, V] never forms. The same on every tp rank."""
    group = _tp_group(mesh)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets[..., None])[..., 0]
    from nos_tpu_torch.parallel.comm import all_reduce_max, reduce_from_group
    from nos_tpu_torch.parallel.mesh import axis_index

    v = logits.shape[-1]
    m = all_reduce_max(logits.detach().amax(dim=-1), group)
    sum_exp = reduce_from_group(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local = targets - axis_index(mesh, "tp") * v
    inside = (local >= 0) & (local < v)
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = reduce_from_group(torch.where(inside, picked, 0.0), group)
    return torch.log(sum_exp) + m - picked


def _sharded_next_token_nll(logits: torch.Tensor, tokens: torch.Tensor,
                            mesh) -> torch.Tensor:
    """``next_token_nll`` of the global batch from this rank's block (its
    vocab shard of the logits under tp): the target of the block's last
    position is the next sp shard's first token (one reverse ring shift
    of a [B, 1] column), the last shard's last position drops, and the
    sum divides by the global count B·(S − 1). The value is the global
    mean on every rank; its gradient is that of this rank's own share
    (the trainer sums the shares over dp and sp)."""
    from nos_tpu_torch.parallel.comm import all_reduce, ring_shift
    from nos_tpu_torch.parallel.mesh import axis_index, axis_size, mesh_groups

    tokens = tokens.to(logits.device).long()
    b, s = tokens.shape
    n_sp = axis_size(mesh, "sp")
    last = axis_index(mesh, "sp") == n_sp - 1
    (nxt,) = ring_shift([tokens[:, :1]], mesh.get_group("sp"), step=-1) \
        if n_sp > 1 else (tokens[:, :1],)
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    nll = _vocab_parallel_nll(logits, targets, mesh)
    if last:
        nll = nll[:, :-1]
    count = b * axis_size(mesh, "dp") * (s * n_sp - 1)
    local = nll.sum() / count
    total = all_reduce(local.detach(), mesh_groups(mesh, ("dp", "sp")))
    # the value is exactly the total on every rank, the gradient local's
    return total + (local - local.detach())


def llama_loss(params: Params, tokens: torch.Tensor, config: LlamaConfig,
               mesh=None) -> torch.Tensor:
    """Next-token cross entropy over shifted tokens: the forward runs on
    the full sequence and the last position's logits are dropped. MoE
    models add ``moe_aux_coef`` times the per-layer balance loss averaged
    over the layers.

    Under a ``mesh``, ``params`` are the rank's shards and ``tokens`` is
    its ``[B/dp, S/sp]`` block; the value is the global batch's loss on
    every rank, and its gradient is this rank's share of the global
    gradient (summed over dp and sp by ``make_train_step``); a MoE
    model's aux term is the global batch's in the same way. Under tp the
    cross entropy is vocab-parallel (``_vocab_parallel_nll``)."""
    if mesh is not None:
        x, aux = _decoder(params, tokens, config, mesh, with_aux=config.n_experts > 0)
        loss = _sharded_next_token_nll(_unembed(params, x, mesh).float(), tokens, mesh)
    else:
        logits, aux = llama_forward(params, tokens, config, with_aux=True)
        loss = next_token_nll(logits, tokens)
    if config.n_experts > 0:
        loss = loss + config.moe_aux_coef * aux / max(1, config.n_layers)
    return loss
