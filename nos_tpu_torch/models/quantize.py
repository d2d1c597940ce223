"""Weight-only int8 / int4 quantization for serving, in PyTorch.

Counterpart of ``nos_tpu/models/quantize.py``: int8 weights with one f32
scale per output channel, int4 weights packed two per byte with one f32
scale per (group, output channel), an int8 embedding with one scale per
vocab row, and int8 MoE expert stacks with one scale per (expert, output
channel). The nodes are ``WeightNode`` leaves of the params dict (as
the reference's are pytree nodes), so ``llama_forward``, ``prefill``,
``decode_step`` and the engine run quantized weights unchanged.

The quantizers round half to even (``torch.round``, as ``jnp.round``)
and divide in f32, so the int8 values, int4 nibbles and scales are the
reference's bit for bit. The products keep the reference's rounding
order: the weight widens to x's dtype (exact), the product runs in that
dtype and the scale applies after it.

Eager PyTorch materializes the widened weight (XLA fuses the widening
into the dot's operand load), so every int8 product reads 1 byte, writes
2 and reads 2 again per weight; no kernel here changes that. For an
expert stack that is the whole stack per product, whichever experts the
tokens reach.

Serving only: quantized weights take no gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from nos_tpu_torch.models.llama import WeightNode, map_leaves, tree_leaves

Params = Dict[str, Any]

# Weight leaves quantized as [in, out] matmul operands.
_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


@dataclass
class QuantizedLinear(WeightNode):
    """int8 weight [in, out] + per-output-channel scale [out] (f32)."""

    q: torch.Tensor
    scale: torch.Tensor
    TENSORS = ("q", "scale")

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.q.to(x.dtype)) * self.scale.to(x.dtype)


@dataclass
class QuantizedLinear4(WeightNode):
    """int4 weight packed two per byte as group-split halves, with
    group-wise scales.

    Layout: q [G, group/2, out] uint8, where within group g the LOW
    nibble of row r holds w[g*group + r] and the HIGH nibble holds
    w[g*group + group/2 + r]; scale [G, out] f32."""

    q: torch.Tensor       # [G, group//2, out] uint8, two nibbles per byte
    scale: torch.Tensor   # [G, out] f32
    group: int
    TENSORS = ("q", "scale")

    def _unpack(self, dtype):
        """(lo, hi) nibble planes [G, half, out] in ``dtype``: the one
        place the packing convention is decoded."""
        lo = ((self.q & 0xF).to(torch.int8) - 8).to(dtype)
        hi = ((self.q >> 4).to(torch.int8) - 8).to(dtype)
        return lo, hi

    def _dequant(self, dtype) -> torch.Tensor:
        lo, hi = self._unpack(torch.float32)
        g, half, out = self.q.shape
        w = torch.cat([lo, hi], dim=1) * self.scale[:, None, :]
        return w.reshape(g * 2 * half, out).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        g, half, out = self.q.shape
        *lead, _ = x.shape
        xg = x.reshape(-1, g, 2, half)
        lo, hi = self._unpack(x.dtype)
        # Two grouped products in x's dtype, then the group scale and
        # the cross-group sum in f32 (the reference's order: one rounding
        # per group-sized partial). acc is f32 [rows, G, out] after the
        # cast: at a [2, 512] prefill of w_gate that is 1.9 GB.
        acc = (torch.einsum("bgi,gio->bgo", xg[:, :, 0], lo)
               + torch.einsum("bgi,gio->bgo", xg[:, :, 1], hi))
        y = (acc.float() * self.scale[None]).sum(dim=1)
        return y.to(x.dtype).reshape(*lead, out)


@dataclass
class QuantizedEmbedding(WeightNode):
    """int8 table [vocab, d] + per-row scale [vocab] (f32); the rows widen
    after the gather, so only the looked-up rows do."""

    q: torch.Tensor
    scale: torch.Tensor
    TENSORS = ("q", "scale")

    def lookup(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        return self.q[tokens].to(dtype) * self.scale[tokens][..., None].to(dtype)

    def as_unembedding(self) -> QuantizedLinear:
        """The tied unembedding: q.T [d, vocab] with per-vocab scales."""
        return QuantizedLinear(q=self.q.T, scale=self.scale)


@dataclass
class QuantizedExpertStack(WeightNode):
    """Stacked MoE expert weights [E, in, out] in int8 with per-(expert,
    output-channel) scales [E, out] (f32)."""

    q: torch.Tensor
    scale: torch.Tensor
    TENSORS = ("q", "scale")

    def expert_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, C, in] → [E, C, out]."""
        return torch.bmm(x, self.q.to(x.dtype)) * self.scale[:, None, :].to(x.dtype)


def _absmax_quantize(w: torch.Tensor, axis: int):
    """Symmetric absmax int8 along ``axis`` (the contraction axis): returns
    (q int8, scale f32 with ``axis`` dropped)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=axis)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return q, scale


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    """[in, out] weight → int8 with one scale per output column."""
    q, scale = _absmax_quantize(w, axis=0)
    return QuantizedLinear(q=q, scale=scale)


def quantize_linear4(w: torch.Tensor, group: int = 128) -> QuantizedLinear4:
    """[in, out] weight → packed int4 with one scale per (group, output
    column). ``group`` clamps to an even divisor of the (even)
    contraction dim."""
    d_in, d_out = w.shape
    if d_in % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {d_in}")
    # Largest EVEN divisor of d_in that is <= the requested group: a
    # byte's two nibbles must not straddle groups (2 always divides).
    group = min(group, d_in)
    group -= group % 2
    while d_in % group:
        group -= 2
    w32 = w.float().reshape(d_in // group, group, d_out)
    absmax = w32.abs().amax(dim=1)                        # [groups, out]
    scale = torch.where(absmax > 0, absmax / 7.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale[:, None, :]), -7, 7).to(torch.int8)
    u = (q + 8).to(torch.uint8)                           # [G, group, out] in [0, 15]
    half = group // 2
    packed = u[:, :half] | (u[:, half:] << 4)             # [G, group/2, out]
    return QuantizedLinear4(q=packed, scale=scale, group=group)


def quantize_embedding(w: torch.Tensor) -> QuantizedEmbedding:
    """[vocab, d] table → int8 with one scale per vocab row."""
    q, scale = _absmax_quantize(w, axis=1)
    return QuantizedEmbedding(q=q, scale=scale)


def quantize_expert_stack(w: torch.Tensor) -> QuantizedExpertStack:
    """[E, in, out] stacked experts → int8 along the contraction axis."""
    q, scale = _absmax_quantize(w, axis=1)
    return QuantizedExpertStack(q=q, scale=scale)


def _quantize_tree(params: Params, linear_fn) -> Params:
    """THE param-tree walk for weight-only quantization, parameterized by
    the dense-linear quantizer (int8 or int4): the embedding stays
    row-gatherable int8, norms keep the model dtype and the MoE router
    f32 (both shared with the input tree, not copied), and expert stacks
    go int8 in either format."""
    out: Params = {
        "embed": quantize_embedding(params["embed"]),
        "final_norm": params["final_norm"],
        "layers": [],
    }
    if "lm_head" in params:  # absent for tied-unembedding models
        out["lm_head"] = linear_fn(params["lm_head"])
    for layer in params["layers"]:
        q_layer: Params = {}
        for key, value in layer.items():
            if key in _LINEAR_KEYS:
                q_layer[key] = linear_fn(value)
            elif key == "moe":
                q_layer[key] = {"router": value["router"],
                                **{k: quantize_expert_stack(value[k])
                                   for k in ("w_gate", "w_up", "w_down")}}
            else:
                q_layer[key] = value
        out["layers"].append(q_layer)
    return out


def quantize_params(params: Params) -> Params:
    """Llama param tree → int8 serving tree (see _quantize_tree)."""
    return _quantize_tree(params, quantize_linear)


def quantize_params_int4(params: Params, group: int = 128) -> Params:
    """Llama param tree → int4 serving tree: dense matmul weights as
    packed group-quantized nibbles; the embedding stays int8 (gathered
    rows cannot read packed pairs cheaply), and so do MoE expert
    stacks."""
    return _quantize_tree(params, lambda w: quantize_linear4(w, group))


def dequantize_params(params: Params, dtype=torch.bfloat16) -> Params:
    """Inverse of the quantizers (up to rounding): every quantized leaf
    expands back to a dense weight in ``dtype``: the fake-quant oracle
    the quantized forward is held against."""

    def expand(leaf):
        if isinstance(leaf, QuantizedLinear4):
            return leaf._dequant(dtype)
        if isinstance(leaf, QuantizedLinear):
            return (leaf.q.float() * leaf.scale[None, :]).to(dtype)
        if isinstance(leaf, QuantizedEmbedding):
            return (leaf.q.float() * leaf.scale[:, None]).to(dtype)
        if isinstance(leaf, QuantizedExpertStack):
            return (leaf.q.float() * leaf.scale[:, None, :]).to(dtype)
        return leaf

    return map_leaves(expand, params)


def weight_bytes(params: Params) -> int:
    """Total bytes of every tensor of the tree (the device working set
    decode streams)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
