"""transformers Llama-family checkpoints → the port's parameter trees.

Counterpart of ``nos_tpu/models/convert.py``, with one code path for
Llama (plain and llama3-scaled RoPE), Mistral (sliding window), Mixtral
(routed MoE) and Gemma (its four dialect switches and head_dim). What the
forward does not implement (other rope_scaling types, attention biases,
leftover adapter weights) is REJECTED at conversion, never converted
into a silently different model.

Layout: transformers' Linear stores [out, in], the tree [in, out], so
matrices transpose; the rotary convention and the GQA head order match
as they are. A tied checkpoint (``tie_word_embeddings``, Gemma) gives a
tree with no ``lm_head``. Mixtral's router (``block_sparse_moe.gate``)
stays f32; its per-expert w1 / w3 / w2 stack into ``[E, in, out]`` on
the host and reach the device in one copy each.

Every tensor passes through f32 on its way to ``config.dtype``, as the
reference casts, and is a new tensor: the tree never aliases the
model's parameters. This module does not import ``transformers``: it
reads a model instance the caller built.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import LlamaConfig

Params = Dict[str, Any]


def config_from_hf(hf_config, dtype=torch.bfloat16) -> LlamaConfig:
    """A transformers config (Llama, Mistral, Mixtral, Gemma) → the
    port's LlamaConfig; raises where the forward would differ."""
    scaling = getattr(hf_config, "rope_scaling", None)
    rope_scaling = None
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", ""))
        if rope_type != "llama3":
            raise ValueError(
                f"rope_scaling={scaling!r} is not implemented by "
                "nos_tpu_torch.models.llama (plain or llama3 RoPE only); "
                "refusing to convert a model whose positions would silently "
                "differ"
            )
        required = (
            "factor", "low_freq_factor", "high_freq_factor",
            "original_max_position_embeddings",
        )
        missing = [k for k in required if k not in scaling]
        if missing:
            raise ValueError(
                f"rope_scaling={scaling!r} lacks {missing}; refusing to "
                "guess scaled-RoPE parameters"
            )
        rope_scaling = ("llama3",) + tuple(float(scaling[k]) for k in required)
    model_type = getattr(hf_config, "model_type", "llama")
    is_gemma = model_type == "gemma"
    head_dim = getattr(hf_config, "head_dim", None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    qk_head_dim = None
    if head_dim not in (None, derived):
        if not is_gemma:
            raise ValueError(
                f"head_dim={head_dim} != hidden_size/num_heads={derived}: "
                "unsupported layout"
            )
        qk_head_dim = int(head_dim)
    hidden_act = getattr(hf_config, "hidden_act", None) or getattr(
        hf_config, "hidden_activation", None
    ) or "silu"
    if hidden_act in ("gelu_pytorch_tanh", "gelu_new") or (
        hidden_act == "gelu" and is_gemma
    ):
        # tanh GELU; a plain "gelu" means it only in Gemma configs (exact
        # erf GELU elsewhere, which the forward does not implement)
        hidden_act = "gelu"
    elif hidden_act != "silu":
        raise ValueError(f"unsupported hidden_act={hidden_act!r}")
    sliding = getattr(hf_config, "sliding_window", None)
    # Mixtral: transformers softmaxes all router logits, then
    # renormalises the top k, as moe_mlp does
    n_experts, moe_top_k = 0, 2
    if model_type == "mixtral":
        n_experts = int(hf_config.num_local_experts)
        moe_top_k = int(getattr(hf_config, "num_experts_per_tok", 2))
    return LlamaConfig(
        n_experts=n_experts,
        moe_top_k=moe_top_k,
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        norm_eps=float(hf_config.rms_norm_eps),
        sliding_window=int(sliding) if sliding else None,
        hidden_act=hidden_act,
        norm_offset=is_gemma,
        scale_embeddings=is_gemma,
        tie_embeddings=is_gemma
        or bool(getattr(hf_config, "tie_word_embeddings", False)),
        qk_head_dim=qk_head_dim,
        dtype=dtype,
    )


def _put(src: torch.Tensor, dtype, device) -> torch.Tensor:
    """A new tensor on ``device`` in ``dtype`` holding ``src`` cast
    through f32."""
    out = torch.empty(src.shape, dtype=dtype, device=device)
    out.copy_(src.detach().float())
    return out


def params_from_hf_state_dict(state_dict, config: LlamaConfig, device=None) -> Params:
    """``model.state_dict()`` of a transformers Llama-family model → the
    port's parameter tree on ``device``, in ``config.dtype``."""
    c = config
    dt = c.dtype
    dev = _resolve_device(device)
    sd = dict(state_dict)
    consumed = set()

    def vec(key, dtype=dt):
        consumed.add(key)
        return _put(sd[key], dtype, dev)

    def mat(key, dtype=dt):  # [out, in] → [in, out]
        consumed.add(key)
        return _put(sd[key].T, dtype, dev)

    embed = vec("model.embed_tokens.weight")
    params: Params = {
        "embed": embed,
        "final_norm": vec("model.norm.weight"),
        "layers": [],
    }
    if c.tie_embeddings:
        # the forward unembeds through embed.T; some exports also carry
        # a copy of it as lm_head
        if "lm_head.weight" in sd:
            consumed.add("lm_head.weight")
    elif "lm_head.weight" in sd:
        params["lm_head"] = mat("lm_head.weight")
    else:  # a tied checkpoint under an untied config: materialize
        params["lm_head"] = embed.T.contiguous()
    for i in range(c.n_layers):
        prefix = f"model.layers.{i}."
        layer = {
            "attn_norm": vec(prefix + "input_layernorm.weight"),
            "wq": mat(prefix + "self_attn.q_proj.weight"),
            "wk": mat(prefix + "self_attn.k_proj.weight"),
            "wv": mat(prefix + "self_attn.v_proj.weight"),
            "wo": mat(prefix + "self_attn.o_proj.weight"),
            "mlp_norm": vec(prefix + "post_attention_layernorm.weight"),
        }
        if c.n_experts > 0:
            moe_prefix = prefix + "block_sparse_moe."

            def stack_experts(name):
                keys = [f"{moe_prefix}experts.{e}.{name}.weight"
                        for e in range(c.n_experts)]
                consumed.update(keys)
                # stacked on the host: one device copy, never two stacks
                stacked = torch.stack([sd[k].detach().cpu().float().T for k in keys])
                return _put(stacked, dt, dev)

            layer["moe"] = {
                "router": mat(moe_prefix + "gate.weight", torch.float32),
                "w_gate": stack_experts("w1"),
                "w_up": stack_experts("w3"),
                "w_down": stack_experts("w2"),
            }
        else:
            layer["w_gate"] = mat(prefix + "mlp.gate_proj.weight")
            layer["w_up"] = mat(prefix + "mlp.up_proj.weight")
            layer["w_down"] = mat(prefix + "mlp.down_proj.weight")
        params["layers"].append(layer)
    # a leftover weight (a bias, an adapter) is one the forward would not
    # apply: refuse rather than serve another model. Rotary frequency
    # buffers are derived state, not weights.
    leftover = [k for k in sd
                if k not in consumed and not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        raise ValueError(
            f"unconverted weights {leftover[:4]}{'...' if len(leftover) > 4 else ''}: "
            "this checkpoint uses features nos_tpu_torch.models.llama does "
            "not implement (biases/adapters?)"
        )
    return params


def load_hf_llama(model, dtype=torch.bfloat16, device=None) -> Tuple[Params, LlamaConfig]:
    """(params, config) from a transformers model instance. A checkpoint
    path is not taken (ROADMAP Queue 1 item 10): build the model with
    transformers and pass it."""
    if isinstance(model, str):
        raise NotImplementedError(
            "loading a checkpoint path is not ported yet (ROADMAP Queue 1 "
            "item 10); pass a transformers model instance"
        )
    config = config_from_hf(model.config, dtype)
    return params_from_hf_state_dict(model.state_dict(), config, device), config
