"""Port weight quantization (nos_tpu_torch.models.quantize) against JAX.

The same weights (the reference's init, bridged) and numpy-seeded tokens
go through both. Tolerances:

- int8 values, int4 nibbles and scales: bit-identical (both round half
  to even and divide in f32 on the same f32 values);
- products and dequantized weights in f32 within 1e-5 (summation order
  only); bf16 products within 2e-2 relative to the output's largest
  value (bf16 intermediates round at other points);
- f32 logits within 1e-4, as the unquantized model (tests/
  test_torch_llama.py); greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.models import quantize as jq
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models import quantize as tq
from tests.test_torch_llama import bridged, tokens_np

F32_ATOL = 1e-4
_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def quantized_both(seed=0, dtype="f32", fmt="int8", group=32, **cfg):
    """(jax config, jax quantized params, port config, port quantized
    params): each side quantizes the same bridged weights itself."""
    jc, jp, tc, tp = bridged(seed, dtype, **cfg)
    if fmt == "int8":
        return jc, jq.quantize_params(jp), tc, tq.quantize_params(tp)
    return (jc, jq.quantize_params_int4(jp, group=group), tc,
            tq.quantize_params_int4(tp, group=group))


def same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)


class TestQuantizerBits:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_int8_values_and_scales_bit_identical(self, dtype):
        jc, jqp, tc, tqp = quantized_both(1, dtype, "int8")
        assert isinstance(tqp["embed"], tq.QuantizedEmbedding)
        assert same_bits(tqp["embed"].q, jqp["embed"].q)
        assert same_bits(tqp["embed"].scale, jqp["embed"].scale)
        assert same_bits(tqp["lm_head"].q, jqp["lm_head"].q)
        for tl_, jl_ in zip(tqp["layers"], jqp["layers"]):
            for key in _LINEAR:
                assert isinstance(tl_[key], tq.QuantizedLinear), key
                assert tl_[key].q.dtype == torch.int8
                assert same_bits(tl_[key].q, jl_[key].q), key
                assert same_bits(tl_[key].scale, jl_[key].scale), key
            assert tl_["attn_norm"].dtype == tc.dtype  # norms stay dense

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("group", [32, 48, 128])
    def test_int4_nibbles_and_scales_bit_identical(self, dtype, group):
        # group 48 clamps to 32 (d_model 64, d_ff 128); 128 clamps to 64
        # on the d_model contractions
        jc, jqp, tc, tqp = quantized_both(2, dtype, "int4", group=group)
        for tl_, jl_ in zip(tqp["layers"], jqp["layers"]):
            for key in _LINEAR:
                node = tl_[key]
                assert isinstance(node, tq.QuantizedLinear4)
                assert node.q.dtype == torch.uint8
                assert node.group == jl_[key].group
                assert same_bits(node.q, jl_[key].q), key
                assert same_bits(node.scale, jl_[key].scale), key
        assert same_bits(tqp["embed"].q, jqp["embed"].q)  # embed stays int8

    @pytest.mark.parametrize("shape,group", [((36, 20), 16), ((64, 24), 128),
                                             ((30, 8), 7)])
    def test_int4_group_clamps_like_the_reference(self, shape, group):
        w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        want = jq.quantize_linear4(jnp.asarray(w), group)
        got = tq.quantize_linear4(torch.from_numpy(w), group)
        assert got.group == want.group and got.q.shape == tuple(want.q.shape)
        assert same_bits(got.q, want.q) and same_bits(got.scale, want.scale)

    def test_zero_columns_take_scale_one(self):
        w = np.zeros((8, 4), np.float32)
        w[:, 1] = np.linspace(-1, 1, 8)
        tw, jw = torch.from_numpy(w), jnp.asarray(w)
        pairs = ((tq.quantize_linear(tw), jq.quantize_linear(jw)),
                 (tq.quantize_linear4(tw, 4), jq.quantize_linear4(jw, 4)))
        for got, want in pairs:
            assert same_bits(got.q, want.q) and same_bits(got.scale, want.scale)
        assert float(pairs[0][0].scale[0]) == 1.0

    def test_guards_raise_where_the_reference_raises(self):
        w = np.ones((7, 4), np.float32)
        with pytest.raises(ValueError, match="even"):
            jq.quantize_linear4(jnp.asarray(w))
        with pytest.raises(ValueError, match="even"):
            tq.quantize_linear4(torch.from_numpy(w))
        # MoE expert stacks quantize (int8 in both formats), the router
        # stays the f32 tensor it was
        router = torch.randn(2, 4)
        stacks = {k: torch.randn(4, 2, 2) for k in ("w_gate", "w_up", "w_down")}
        tree = {"embed": torch.ones(4, 2), "final_norm": torch.ones(2),
                "layers": [{"moe": dict(router=router, **stacks)}]}
        for fn in (tq.quantize_params, lambda p: tq.quantize_params_int4(p, 2)):
            node = fn(tree)["layers"][0]["moe"]
            assert node["router"] is router
            for key, w in stacks.items():
                want = jq.quantize_expert_stack(jnp.asarray(w.numpy()))
                assert isinstance(node[key], tq.QuantizedExpertStack)
                assert same_bits(node[key].q, want.q) and same_bits(node[key].scale, want.scale)


class TestProducts:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_matmul_and_lookup_match_reference(self, dtype):
        jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (
            jnp.bfloat16, torch.bfloat16)
        rng = np.random.default_rng(4)
        w = rng.standard_normal((64, 48)).astype(np.float32)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32)
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        pairs = [
            (jq.quantize_linear(jnp.asarray(w)), tq.quantize_linear(torch.from_numpy(w))),
            (jq.quantize_linear4(jnp.asarray(w), 16),
             tq.quantize_linear4(torch.from_numpy(w), 16)),
        ]
        for jnode, tnode in pairs:
            want = np.asarray(jnode.matmul(xj), np.float32)
            got = tnode.matmul(xt)
            assert got.dtype == tdt and got.shape == (3, 5, 48)
            err = float(np.abs(got.float().numpy() - want).max())
            limit = 1e-5 if dtype == "f32" else 2e-2 * float(np.abs(want).max())
            assert err <= limit, err
        toks = np.array([[3, 0, 63], [7, 7, 1]], np.int32)
        je, te = jq.quantize_embedding(jnp.asarray(w)), tq.quantize_embedding(
            torch.from_numpy(w))
        want = np.asarray(je.lookup(jnp.asarray(toks), jdt), np.float32)
        got = te.lookup(t(toks), tdt)
        assert got.dtype == tdt
        assert np.array_equal(got.float().numpy(), want)  # one product per element

    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    def test_dequantize_params_matches_reference(self, fmt):
        jc, jqp, tc, tqp = quantized_both(5, "f32", fmt, group=16)
        want = jax.tree.map(np.asarray, jq.dequantize_params(jqp, jnp.float32))
        got = tq.dequantize_params(tqp, torch.float32)
        assert np.array_equal(got["embed"].numpy(), want["embed"])
        for tl_, jl_ in zip(got["layers"], want["layers"]):
            for key in _LINEAR:
                assert isinstance(tl_[key], torch.Tensor)
                assert float(np.abs(tl_[key].numpy() - jl_[key]).max()) <= 1e-6, key

    @pytest.mark.parametrize("fmt", ["dense", "int8", "int4"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_weight_bytes_match_reference(self, fmt, dtype):
        if fmt == "dense":
            jc, jp, tc, tp = bridged(6, dtype)
            assert tq.weight_bytes(tp) == jq.weight_bytes(jp)
            return
        jc, jqp, tc, tqp = quantized_both(6, dtype, fmt, group=32)
        assert tq.weight_bytes(tqp) == jq.weight_bytes(jqp)

    def test_roundtrip_requantize_is_a_fixed_point(self):
        _, _, tc, tp = bridged(7)
        q1 = tq.quantize_params(tp)
        q2 = tq.quantize_params(tq.dequantize_params(q1, torch.float32))
        assert torch.equal(q1["layers"][0]["wq"].q, q2["layers"][0]["wq"].q)


class TestQuantizedModel:
    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_forward_logits_match_reference(self, fmt, attention):
        jc, jqp, tc, tqp = quantized_both(8, "f32", fmt, group=16, attention=attention)
        toks = tokens_np(8)
        want = np.asarray(jl.llama_forward(jqp, jnp.asarray(toks), jc))
        got = tl.llama_forward(tqp, t(toks), tc).numpy()
        assert np.abs(got - want).max() <= F32_ATOL

    def test_forward_against_the_fake_quant_oracle(self):
        _, _, tc, tp = bridged(9)
        qp = tq.quantize_params(tp)
        toks = t(tokens_np(9))
        got = tl.llama_forward(qp, toks, tc)
        oracle = tl.llama_forward(tq.dequantize_params(qp, torch.float32), toks, tc)
        # the same products in another order: widen-then-scale against
        # scale-then-multiply, f32
        assert float((got - oracle).abs().max()) <= 1e-4

    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_greedy_generate_token_identical(self, fmt, kv_quant):
        jc, jqp, tc, tqp = quantized_both(10, "f32", fmt, group=16)
        toks = tokens_np(10, s=9)
        want = np.asarray(jg.generate(jqp, jnp.asarray(toks), jc, 10, kv_quant=kv_quant))
        got = tg.generate(tqp, t(toks), tc, 10, kv_quant=kv_quant)
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    def test_left_padded_generate_token_identical(self, fmt):
        jc, jqp, tc, tqp = quantized_both(11, "f32", fmt, group=16)
        toks = tokens_np(11, s=10)
        toks[toks == 0] = 1
        toks[0, :4] = 0
        for kv_quant in (False, True):
            want = np.asarray(jg.generate(jqp, jnp.asarray(toks), jc, 8, pad_id=0,
                                          kv_quant=kv_quant))
            got = tg.generate(tqp, t(toks), tc, 8, pad_id=0, kv_quant=kv_quant)
            assert np.array_equal(got.numpy(), want)

    def test_tied_gemma_int4_unembedding(self):
        """A quantized tied embedding unembeds as a QuantizedLinear over
        q.T with per-vocab scales (mirrors tests/models/test_quantize.py's
        tied-Gemma int4 case)."""
        jc, jqp, tc, tqp = quantized_both(
            12, "f32", "int4", group=16, hidden_act="gelu", norm_offset=True,
            scale_embeddings=True, tie_embeddings=True,
        )
        assert "lm_head" not in tqp
        unembed = tl._unembed_weight(tqp)
        assert isinstance(unembed, tq.QuantizedLinear)
        assert unembed.q.shape == (64, 256) and unembed.scale.shape == (256,)
        toks = tokens_np(12, s=6)
        want = np.asarray(jl.llama_forward(jqp, jnp.asarray(toks), jc))
        got = tl.llama_forward(tqp, t(toks), tc).numpy()
        assert np.abs(got - want).max() <= F32_ATOL
        want = np.asarray(jg.generate(jqp, jnp.asarray(toks), jc, 6))
        assert np.array_equal(tg.generate(tqp, t(toks), tc, 6).numpy(), want)


class TestBridgeCarriesNodes:
    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    def test_reference_nodes_cross_with_their_own_dtypes(self, fmt):
        jc, jp, tc, tp = bridged(13, "bf16")
        jqp = jq.quantize_params(jp) if fmt == "int8" else jq.quantize_params_int4(jp, 32)
        crossed = params_from_numpy(jax.tree.map(np.asarray, jqp), tc, device="cpu")
        mine = tq.quantize_params(tp) if fmt == "int8" else tq.quantize_params_int4(tp, 32)
        assert isinstance(crossed["embed"], tq.QuantizedEmbedding)
        for a, b in zip(tl.tree_leaves(crossed), tl.tree_leaves(mine)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        node = crossed["layers"][0]["wq"]
        assert node.scale.dtype == torch.float32
        assert node.q.dtype == (torch.int8 if fmt == "int8" else torch.uint8)
        assert tl.params_device(crossed) == torch.device("cpu")
