"""Autoregressive generation with a KV cache, in PyTorch.

Counterpart of ``nos_tpu/models/generate.py``: ``prefill`` runs the
prompt once and keeps every layer's K/V in a static ``[B, max_len, Hkv,
hd]`` cache; ``decode_step`` / ``decode_chunk`` then attend one or a few
query positions against it, masked by position (no dynamic shapes).

Differences from the reference, all deliberate:

- The cache is updated IN PLACE (the reference returns a new one); the
  functions still return it, so call sites read the same.
- Out-of-range writes, which the reference's scatter silently drops, are
  masked explicitly: a per-row ``decode_step`` write past the cache
  keeps the slot's old value; a scalar ``pos`` clamps into the cache like
  ``dynamic_update_slice``; a ``decode_chunk`` write outside the cache
  goes, like a pad's, to the sacrificial last slot its contract reserves.
- Sampling draws from ``torch.Generator``s, not ``jax.random`` keys:
  reproducible per seed, never bitwise equal to the reference.
- Tensor and expert parallelism: ``prefill`` / ``decode_step`` /
  ``decode_chunk`` / ``generate`` take ``mesh`` (a ``DeviceMesh`` with
  ``tp`` and / or ``ep`` axes; the reference's functions need none, its
  arrays carry their layout). The params are the rank's shards
  (``serve/sharded.py:shard_for_serving``), the cache holds the rank's
  ``n_kv_heads/tp`` heads (``init_kv_cache(..., mesh=)``; replicated
  over ep), a MoE layer runs the rank's experts and gathers their
  outputs over ep, and the logits are gathered over tp, so every rank
  picks the same token from the same bytes; every rank of the mesh
  calls together.

The int8 KV cache (``quant`` / ``kv_quant``) keeps the reference's
rounding order: the prompt's own attention runs on the exact fresh K/V,
``k_scale`` multiplies the f32 scores before the 1/sqrt(hd), ``v_scale``
is cast to the model dtype and folded into the probabilities after their
cast, and int8 widens to the model dtype (exact) before the f32 products.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    _apply_rope,
    _attn_out,
    _check_mesh,
    _embed,
    _grouped_scores,
    _grouped_values,
    _logits,
    _mlp,
    _qkv,
    _rms_norm,
    _rope,
    _rope_at,
    _window_causal_mask,
    llama_forward,
    params_device,
)
from nos_tpu_torch.models.moe import moe_mlp

Cache = List[Dict[str, torch.Tensor]]


def init_kv_cache(
    config: LlamaConfig, batch: int, max_len: int, quant: bool = False,
    device=None, mesh=None,
) -> Cache:
    """Per-layer K/V buffers [B, max_len, Hkv, hd] in the model dtype;
    under a ``mesh`` with tp the rank's ``Hkv/tp`` heads only (the
    head-sharded cache: attention is head-local, so cache reads and
    writes never cross ranks).

    ``quant``: int8 K/V with per-(row, slot, head) f32 absmax scales
    ``k_scale`` / ``v_scale`` [B, max_len, Hkv]: half the cache bytes of
    bf16. Lossy on every decode read; the prompt's own prefill attention
    stays exact."""
    from nos_tpu_torch.parallel.mesh import axis_size

    c = config
    dev = _resolve_device(device)
    tp = axis_size(mesh, "tp")
    if c.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={c.n_kv_heads} (head-sharded KV cache)"
        )
    shape = (batch, max_len, c.n_kv_heads // tp, c.head_dim)
    if not quant:
        return [
            {
                "k": torch.zeros(shape, dtype=c.dtype, device=dev),
                "v": torch.zeros(shape, dtype=c.dtype, device=dev),
            }
            for _ in range(c.n_layers)
        ]
    return [
        {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        }
        for _ in range(c.n_layers)
    ]


def _kv_quantized(cache: Cache) -> bool:
    return bool(cache) and "k_scale" in cache[0]


def _quantize_kv(vec: torch.Tensor):
    """[..., hd] → (int8 [..., hd], f32 scale [...]): symmetric absmax
    over the head dim, one scale per written K/V vector."""
    v32 = vec.float()
    absmax = v32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(v32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _cache_kv(k, v, dtype, quant: bool) -> Dict[str, torch.Tensor]:
    """The values one write stores: K/V in the model dtype, or int8 K/V
    with their scales."""
    if not quant:
        return {"k": k.to(dtype), "v": v.to(dtype)}
    k8, ks = _quantize_kv(k)
    v8, vs = _quantize_kv(v)
    return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}


def _ffn(h: torch.Tensor, layer: Params, config: LlamaConfig, token_mask=None,
         mesh=None):
    """The block's MLP: dense (tensor-parallel under a mesh), or the
    routed mixture for a ``moe`` layer (over tp and ep under a mesh).
    ``token_mask`` [B, S] keeps pads and dead rows out of the MoE
    capacity race (a dense MLP is per token, so it needs none)."""
    if "moe" in layer:
        return moe_mlp(layer["moe"], h, config.moe_config(), mesh, token_mask=token_mask)
    return _mlp(h, layer, config.hidden_act, mesh)


def _cache_attention(
    q, cache_k, cache_v, n_valid, config: LlamaConfig, key_valid=None,
    rolling: int = 0, k_scale=None, v_scale=None,
):
    """q [B, S, Hq, hd] against cache [B, T, Hkv, hd], masked to the first
    ``n_valid`` positions: a scalar (one shared frontier), [B] (per-row
    frontiers) or [B, S] (per-query frontiers: query i sees keys
    [0, pos+i+1)). ``key_valid`` [B, T] also masks pad slots.

    ``rolling`` = C > 0: physical slot s holds logical position
    l_s = (f-1) - ((f-1-s) mod C) for frontier f; valid when l_s >= 0
    and inside the window. Slots >= C are never valid.

    ``k_scale`` / ``v_scale`` [B, T, Hkv]: an int8 cache. K widens to
    q's dtype and its scales multiply the f32 scores; the V scales fold
    into the probabilities (in q's dtype) before the value product."""
    c = config
    b, s, hq, hd = q.shape
    t = cache_k.shape[1]
    dev = q.device
    if k_scale is not None:
        cache_k = cache_k.to(q.dtype)
    scores = _grouped_scores(q, cache_k, cache_k.shape[2])
    if k_scale is not None:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    scores = scores / math.sqrt(hd)
    iota = torch.arange(t, device=dev).reshape(1, 1, 1, 1, t)
    nv = torch.as_tensor(n_valid, device=dev)
    if nv.dim() == 2:
        frontier = nv[:, None, None, :, None]
    elif nv.dim() == 1:
        frontier = nv[:, None, None, None, None]
    else:
        frontier = nv
    if rolling:
        if c.sliding_window is None:
            raise ValueError("rolling cache requires sliding_window")
        f1 = frontier - 1
        ls = f1 - torch.remainder(f1 - iota, rolling)
        valid = (ls >= 0) & (ls > f1 - c.sliding_window) & (iota < rolling)
    else:
        valid = iota < frontier
        if c.sliding_window is not None:
            valid = valid & (iota >= frontier - c.sliding_window)
    if key_valid is not None:
        kv_mask = torch.as_tensor(key_valid, device=dev)
        valid = valid & kv_mask[:, None, None, None, :]
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if v_scale is not None:
        # sum_t p * (v8 * s) = sum_t (p * s) * v8: no widened-and-scaled V
        probs = probs * v_scale.transpose(1, 2).to(probs.dtype)[:, :, None, None, :]
        cache_v = cache_v.to(q.dtype)
    return _grouped_values(probs, cache_v)


def prefill(
    params: Params, tokens: torch.Tensor, config: LlamaConfig, max_len: int,
    pad_id: Optional[int] = None, quant: bool = False, *, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Full forward over the prompt → (logits [B, S, vocab] f32, cache
    holding the prompt's K/V in positions [0, S)).

    ``pad_id`` enables LEFT-padded batches: pads are masked out of
    attention and RoPE counts only real tokens, and on MoE models pads
    claim no expert capacity. Unpadded prompts run the flash kernel when
    the config asks for it; padded ones need per-key masks the kernel
    does not take and stay dense. ``quant``: an int8 cache; the prompt's
    own attention still runs on the exact K/V. ``mesh``: tensor-parallel
    (see the module docstring)."""
    c = config
    _check_mesh(mesh, c)
    dev = params_device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache capacity {max_len}")
    if c.sliding_window is not None and pad_id is not None:
        raise ValueError(
            "sliding_window does not support left-padded prompts; batch "
            "via the engine's chunked admission instead"
        )
    hd = c.head_dim
    x = _embed(params, tokens, c, mesh)
    if pad_id is None:
        cos, sin = _rope(s, hd, c.rope_theta, c.dtype, c.rope_scaling, device=dev)
        token_valid = None
    else:
        token_valid = tokens != pad_id  # [B, S]
        positions = (torch.cumsum(token_valid, dim=1) - 1).clamp(min=0)
        cos, sin = _rope_at(
            positions.reshape(-1), hd, c.rope_theta, c.dtype, c.rope_scaling
        )
        cos = cos.reshape(b, s, 1, -1)  # per-row tables
        sin = sin.reshape(b, s, 1, -1)
    cache = init_kv_cache(c, b, max_len, quant=quant, device=dev, mesh=mesh)
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["attn_norm"], c.norm_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, mesh)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        for key, val in _cache_kv(k, v, c.dtype, quant).items():
            cache[i][key][:, :s] = val
        if c.attention == "flash" and pad_id is None:
            from nos_tpu_torch.ops.flash_attention import flash_attention

            attn = flash_attention(
                q, k, v, causal=True, window=c.sliding_window
            ).reshape(b, s, -1)
        else:
            scores = _grouped_scores(q, k, k.shape[2]) / math.sqrt(hd)
            mask = _window_causal_mask(s, c.sliding_window, dev)[None, None, None]
            if token_valid is not None:
                mask = mask & token_valid[:, None, None, None, :]
            scores = torch.where(mask, scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            attn = _grouped_values(probs, v)
        x = x + _attn_out(attn, layer, mesh)
        x = x + _ffn(
            _rms_norm(x, layer["mlp_norm"], c.norm_eps, c.norm_offset),
            layer, c, token_mask=token_valid, mesh=mesh,
        )
    x = _rms_norm(x, params["final_norm"], c.norm_eps, c.norm_offset)
    return _logits(params, x, mesh), cache


def _write_rows(buf: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor,
                keep: torch.Tensor) -> None:
    """buf[r, slot[r]] = vals[r] where keep[r]; rows with keep False
    leave the (clamped) slot as it was — the reference's dropped scatter
    write. Rows are distinct, so no two writes collide. ``vals`` is
    [B, ...] of any rank (a K/V row [B, Hkv, hd], a scale row [B, Hkv])."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    old = buf[rows, slot]
    mask = keep.reshape(-1, *([1] * (old.dim() - 1)))
    buf[rows, slot] = torch.where(mask, vals.to(buf.dtype), old)


def decode_step(
    params: Params,
    cache: Cache,
    pos,
    token: torch.Tensor,
    config: LlamaConfig,
    rope_pos=None,
    key_valid=None,
    row_valid=None,
    rolling: bool = False,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """One token at cache slot ``pos`` → (logits [B, vocab] f32, the
    cache with K/V written at pos, in place).

    ``pos`` is a scalar (one slot for every row; ``rope_pos`` [B] then
    carries each row's logical position under left padding) or [B]
    (per-row depths, continuous batching; rope defaults to pos).
    ``key_valid`` [B, T] masks pad slots. ``row_valid`` [B] marks rows
    carrying a real token: the others stay out of the MoE expert-capacity
    race, so an idle slot never displaces a live one. It defaults to "has
    any valid key" when ``key_valid`` is given (the engine clears a
    retired row's). ``rolling``: physical slot = pos mod C, C =
    cache_len - 1 (per-row pos only). ``mesh``: tensor-parallel."""
    c = config
    _check_mesh(mesh, c)
    dev = params_device(params)
    token = torch.as_tensor(token, device=dev)
    b = token.shape[0]
    hd = c.head_dim
    pos_t = torch.as_tensor(pos, device=dev)
    per_row = pos_t.dim() == 1
    t_cache = cache[0]["k"].shape[1]
    cap = t_cache - 1 if rolling else 0
    if rolling and not per_row:
        raise ValueError("rolling decode needs per-row positions")
    quant = _kv_quantized(cache)
    if key_valid is not None:
        key_valid = torch.as_tensor(key_valid, device=dev)
        if row_valid is None:
            row_valid = key_valid.any(dim=1)
    ffn_mask = None if row_valid is None else torch.as_tensor(row_valid, device=dev)[:, None]
    x = _embed(params, token, c, mesh)[:, None, :]
    if rope_pos is None and per_row:
        rope_pos = pos_t
    if rope_pos is None:
        cos, sin = _rope_at(pos_t.reshape(1), hd, c.rope_theta, c.dtype, c.rope_scaling)
        cos = cos.reshape(1, 1, 1, -1)  # broadcast over rows
        sin = sin.reshape(1, 1, 1, -1)
    else:
        rp = torch.as_tensor(rope_pos, device=dev)
        cos, sin = _rope_at(rp, hd, c.rope_theta, c.dtype, c.rope_scaling)
        cos = cos[:, None, None, :]  # per-row tables
        sin = sin[:, None, None, :]
    if per_row:
        wslot = torch.remainder(pos_t, cap) if rolling else pos_t
        in_cache = (wslot >= 0) & (wslot < t_cache)
        wslot = wslot.clamp(0, t_cache - 1)
    else:
        # dynamic_update_slice semantics: the start clamps into the cache
        wslot = pos_t.clamp(0, t_cache - 1).reshape(1)
    for layer, kv in zip(params["layers"], cache):
        h = _rms_norm(x, layer["attn_norm"], c.norm_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, mesh)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        for key, val in _cache_kv(k, v, c.dtype, quant).items():
            if per_row:
                _write_rows(kv[key], wslot, val[:, 0], in_cache)
            else:
                kv[key].index_copy_(1, wslot, val)
        attn = _cache_attention(
            q, kv["k"], kv["v"], pos_t + 1, c, key_valid=key_valid, rolling=cap,
            k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"),
        )
        x = x + _attn_out(attn, layer, mesh)
        x = x + _ffn(
            _rms_norm(x, layer["mlp_norm"], c.norm_eps, c.norm_offset),
            layer, c, token_mask=ffn_mask, mesh=mesh,
        )
    x = _rms_norm(x, params["final_norm"], c.norm_eps, c.norm_offset)
    return _logits(params, x[:, 0], mesh), cache


def decode_chunk(
    params: Params,
    cache: Cache,
    pos,
    tokens: torch.Tensor,
    config: LlamaConfig,
    write_mask=None,
    row_valid=None,
    rolling: bool = False,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """``m`` tokens at per-row slots ``pos``..``pos+m-1`` → (logits
    [B, m, vocab] f32, the cache with the chunk's K/V written in place).

    Query i attends the cache frontier [0, pos+i+1). ``write_mask``
    [B, m] marks REAL positions: pads write to the cache's LAST slot,
    which callers reserve (a frontier never reaches it) — and so does
    any write that would land outside the cache — and on MoE models they
    claim no expert capacity and emit zero from the mixture.
    ``row_valid`` [B] also keeps WHOLE rows out of the capacity race
    (finished slots riding a speculative round). ``rolling``: modular
    layout over C = cache_len - 1 slots; needs C >= window + m.
    ``mesh``: tensor-parallel."""
    c = config
    _check_mesh(mesh, c)
    dev = params_device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    pos = torch.as_tensor(pos, device=dev)
    b, m = tokens.shape
    hd = c.head_dim
    quant = _kv_quantized(cache)
    x = _embed(params, tokens, c, mesh)  # [B, m, D]
    posmat = pos[:, None] + torch.arange(m, device=dev, dtype=pos.dtype)[None, :]
    cos, sin = _rope_at(posmat.reshape(-1), hd, c.rope_theta, c.dtype, c.rope_scaling)
    cos = cos.reshape(b, m, 1, -1)
    sin = sin.reshape(b, m, 1, -1)
    t_cache = cache[0]["k"].shape[1]
    cap = t_cache - 1 if rolling else 0
    write_pos = torch.remainder(posmat, cap) if rolling else posmat
    ffn_mask = None
    if write_mask is not None:
        ffn_mask = torch.as_tensor(write_mask, device=dev)
        write_pos = torch.where(ffn_mask, write_pos, t_cache - 1)
    if row_valid is not None:
        row_col = torch.as_tensor(row_valid, device=dev)[:, None].expand(b, m)
        ffn_mask = row_col if ffn_mask is None else ffn_mask & row_col
    write_pos = torch.where(
        (write_pos >= 0) & (write_pos < t_cache), write_pos, t_cache - 1
    )
    rows = torch.arange(b, device=dev)[:, None].expand(b, m)
    frontier = posmat + 1  # [B, m]: query i sees keys < pos+i+1
    for layer, kv in zip(params["layers"], cache):
        h = _rms_norm(x, layer["attn_norm"], c.norm_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, mesh)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        for key, val in _cache_kv(k, v, c.dtype, quant).items():
            kv[key][rows, write_pos] = val
        attn = _cache_attention(q, kv["k"], kv["v"], frontier, c, rolling=cap,
                                k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"))
        x = x + _attn_out(attn, layer, mesh)
        x = x + _ffn(
            _rms_norm(x, layer["mlp_norm"], c.norm_eps, c.norm_offset),
            layer, c, token_mask=ffn_mask, mesh=mesh,
        )
    x = _rms_norm(x, params["final_norm"], c.norm_eps, c.norm_offset)
    return _logits(params, x, mesh), cache


# ---------------------------------------------------------------- sampling


def _nucleus_cutoff(sorted_desc: torch.Tensor, top_p) -> torch.Tensor:
    """THE nucleus rule: given descending-sorted logits [..., V] and a
    broadcastable top_p, the per-row cutoff logit. A rank is kept while
    the mass strictly above it is < p; rank 0 is always kept, so
    top_p <= 0 degrades to greedy instead of masking everything."""
    probs = torch.softmax(sorted_desc, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = mass_before < top_p
    keep[..., 0] = True
    inf = torch.full_like(sorted_desc, math.inf)
    return torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k then nucleus filtering with fixed parameters; masked entries
    go to -inf so sampling never draws them."""
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        cutoff = _nucleus_cutoff(sorted_desc, top_p)
        logits = torch.where(logits < cutoff, -math.inf, logits)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw from softmax(logits) [V] → a 1-element long tensor."""
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)


def pick_tokens_per_row(
    logits: torch.Tensor,
    temp: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    generators: Sequence[Optional[torch.Generator]],
) -> torch.Tensor:
    """Per-row next token for mixed batches: greedy where temp == 0, else
    temperature sampling with per-row top-k / nucleus parameters. Row r
    draws from ``generators[r]`` alone (None: a greedy row, no draw), so
    its stream depends only on its own generator, never on its slot or
    co-tenants. One descending sort serves both filters."""
    v = logits.shape[-1]
    dev = logits.device
    temp = torch.as_tensor(temp, device=dev)
    top_k = torch.as_tensor(top_k, device=dev)
    top_p = torch.as_tensor(top_p, device=dev)
    greedy = logits.argmax(dim=-1)
    scaled = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_k - 1).clamp(0, v - 1).long()
    kth = torch.gather(sorted_desc, -1, k_idx[:, None])
    kth = torch.where((top_k > 0)[:, None], kth, -math.inf)
    filtered = torch.where(scaled < kth, -math.inf, scaled)
    sorted2 = torch.where(sorted_desc < kth, -math.inf, sorted_desc)
    cutoff = _nucleus_cutoff(sorted2, top_p[:, None])
    filtered = torch.where(filtered < cutoff, -math.inf, filtered)
    out = greedy.clone()
    for r, gen in enumerate(generators):
        if gen is not None:
            out[r:r + 1] = _categorical(filtered[r], gen)
    return torch.where(temp > 0, out, greedy)


def generate(
    params: Params,
    prompt: torch.Tensor,
    config: LlamaConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    rng: Optional[torch.Generator] = None,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
    pad_id: Optional[int] = None,
    eos_id: Optional[int] = None,
    kv_quant: bool = False,
    mesh=None,
) -> torch.Tensor:
    """prompt [B, S] → generated tokens [B, max_new_tokens].

    Greedy when temperature == 0, else temperature sampling with optional
    top-k / nucleus filtering, drawing from ``rng`` (a generator on the
    params' device; default seeded 0). ``pad_id``: LEFT-padded
    variable-length prompts. ``eos_id``: a row that emits it keeps
    emitting it. The reference scans max_new_tokens decode steps and
    discards the last one's output; this loop runs only the steps whose
    tokens it returns. ``kv_quant``: an int8 cache (see init_kv_cache).
    ``mesh``: tensor-parallel (every rank gets the same tokens; a sampling
    ``rng`` must be seeded alike on every rank)."""
    c = config
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    logits, cache = prefill(params, prompt, c, s + max_new_tokens, pad_id=pad_id,
                            quant=kv_quant, mesh=mesh)
    if rng is None and temperature > 0.0:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)
    if pad_id is not None:
        token_valid = prompt != pad_id
        rope_pos = token_valid.sum(dim=1)  # next logical position per row
        key_valid = F.pad(token_valid, (0, max_new_tokens), value=True)
    else:
        rope_pos = None
        key_valid = None

    def pick(lg):
        if temperature <= 0.0:
            return lg.argmax(dim=-1)
        filtered = _filter_logits(lg / temperature, top_k, top_p)
        return torch.multinomial(
            torch.softmax(filtered, dim=-1), 1, generator=rng
        )[:, 0]

    token = pick(logits[:, -1])
    done = None if eos_id is None else token == eos_id
    out = [token]
    for step in range(1, max_new_tokens):
        logits, cache = decode_step(
            params, cache, s + step - 1, token, c, rope_pos=rope_pos,
            key_valid=key_valid, mesh=mesh,
        )
        token = pick(logits)
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        if rope_pos is not None:
            rope_pos = rope_pos + 1
        out.append(token)
    return torch.stack(out, dim=1).to(prompt.dtype)


def reference_generate(
    params: Params, prompt: torch.Tensor, config: LlamaConfig, max_new_tokens: int
) -> torch.Tensor:
    """Cache-free greedy generation (re-forwards the whole sequence every
    step): the oracle the cached path is tested against."""
    tokens = torch.as_tensor(prompt, device=params_device(params))
    for _ in range(max_new_tokens):
        logits = llama_forward(params, tokens, config)
        nxt = logits[:, -1].argmax(dim=-1).to(tokens.dtype)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens[:, prompt.shape[1]:]
