"""Port Llama model (nos_tpu_torch.models.llama + bridge) against JAX.

Weights come from the reference's own init and cross through the bridge
as numpy arrays; token ids come from numpy with a fixed seed.

Tolerances: f32 logits agree to 1e-4 — identical arithmetic, only the
matmul summation order differs (observed ~3e-6). bf16 configs are held
to the reference tests' own bf16 contract (tests/ops/
test_flash_attention.py): logits within 1e-1 and softmax probabilities
within 3e-3, because the two frameworks round bf16 intermediates at
different points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl

F32_ATOL = 1e-4
BF16_LOGIT_ATOL = 1e-1
BF16_PROB_ATOL = 3e-3

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype="f32", **overrides):
    jdt, tdt = _DTYPES[dtype]
    return jl.tiny_config(dtype=jdt, **overrides), tl.tiny_config(dtype=tdt, **overrides)


def bridged(seed=0, dtype="f32", perturb_norms=False, **overrides):
    """(jax config, jax params, port config, port params) on shared weights."""
    jc, tc = configs(dtype, **overrides)
    jp = jl.init_llama_params(jax.random.key(seed), jc)
    tree = jax.tree.map(np.asarray, jp)
    if perturb_norms:
        # init norms are constants; random ones exercise the norm math
        rng = np.random.default_rng(seed + 100)
        for layer in tree["layers"]:
            for key in ("attn_norm", "mlp_norm"):
                layer[key] = (rng.standard_normal(layer[key].shape) * 0.1).astype(
                    layer[key].dtype
                )
        jp = jax.tree.map(jnp.asarray, tree)
    return jc, jp, tc, params_from_numpy(tree, tc, device="cpu")


def tokens_np(seed, b=2, s=16, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def forward_both(jc, jp, tc, tp, toks):
    want = np.array(jl.llama_forward(jp, jnp.asarray(toks), jc))
    got = tl.llama_forward(tp, torch.from_numpy(toks).long(), tc)
    assert got.dtype == torch.float32
    return got.numpy(), want


class TestForwardParity:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_f32_logits(self, attention):
        toks = tokens_np(1)
        got, want = forward_both(*bridged(0, attention=attention), toks)
        assert got.shape == (2, 16, 256)
        assert np.abs(got - want).max() <= F32_ATOL

    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_bf16_logits(self, attention):
        got, want = forward_both(*bridged(0, "bf16", attention=attention), tokens_np(2))
        assert np.abs(got - want).max() <= BF16_LOGIT_ATOL
        pg = torch.softmax(torch.from_numpy(got), -1)
        pw = torch.softmax(torch.from_numpy(want), -1)
        assert float((pg - pw).abs().max()) <= BF16_PROB_ATOL

    def test_gemma_dialect(self):
        parts = bridged(
            3, perturb_norms=True, hidden_act="gelu", norm_offset=True,
            scale_embeddings=True, tie_embeddings=True, qk_head_dim=16,
            n_kv_heads=1, d_model=96, n_heads=4,
        )
        assert "lm_head" not in parts[3]
        got, want = forward_both(*parts, tokens_np(4))
        assert np.abs(got - want).max() <= F32_ATOL

    def test_llama3_rope_scaling(self):
        scaling = ("llama3", 8.0, 1.0, 4.0, 8)
        toks = tokens_np(5, s=32)
        got, want = forward_both(*bridged(5, rope_scaling=scaling), toks)
        assert np.abs(got - want).max() <= F32_ATOL
        # the scaling actually moves the output
        plain, _ = forward_both(*bridged(5), toks)
        assert np.abs(plain - got).max() > 1e-3

    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_sliding_window(self, attention):
        parts = bridged(6, sliding_window=5, attention=attention)
        got, want = forward_both(*parts, tokens_np(6, s=24))
        assert np.abs(got - want).max() <= F32_ATOL

    def test_next_token_nll(self):
        jc, jp, tc, tp = bridged(7)
        toks = tokens_np(7)
        want = float(jl.next_token_nll(jl.llama_forward(jp, jnp.asarray(toks), jc),
                                       jnp.asarray(toks)))
        t_toks = torch.from_numpy(toks).long()
        got = float(tl.next_token_nll(tl.llama_forward(tp, t_toks, tc), t_toks))
        assert abs(got - want) <= 1e-5


    def test_remat_gradients_match(self):
        import dataclasses

        _, _, tc, tp = bridged(13)
        toks = torch.from_numpy(tokens_np(13)).long()

        def grads(cfg):
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in tp["layers"][0].items()}
            params = dict(tp, layers=[leaves] + tp["layers"][1:])
            tl.next_token_nll(tl.llama_forward(params, toks, cfg), toks).backward()
            return leaves["wq"].grad

        plain = grads(tc)
        remat = grads(dataclasses.replace(tc, remat=True))
        assert float((plain - remat).abs().max()) <= 1e-6


class TestDtypeRounding:
    def test_embed_scale_rounds_to_model_dtype(self):
        jc, tc = configs("bf16", d_model=96, scale_embeddings=True)
        assert tc.embed_scale.dtype == torch.bfloat16
        assert float(tc.embed_scale) == float(jnp.asarray(jc.embed_scale, jnp.float32))
        assert float(tc.embed_scale) != 96 ** 0.5  # really rounded

    def test_rope_tables_and_rotation_match(self):
        pos = np.arange(40, dtype=np.int32)
        for scaling in (None, ("llama3", 8.0, 1.0, 4.0, 16)):
            jcos, jsin = jl._rope_at(jnp.asarray(pos), 16, 500000.0, jnp.float32, scaling)
            tcos, tsin = tl._rope_at(torch.from_numpy(pos), 16, 500000.0, torch.float32, scaling)
            assert np.abs(tcos.numpy() - np.asarray(jcos)).max() <= 1e-6
            assert np.abs(tsin.numpy() - np.asarray(jsin)).max() <= 1e-6
        x = np.random.default_rng(8).standard_normal((1, 40, 2, 16)).astype(np.float32)
        want = jl._apply_rope(jnp.asarray(x), jcos, jsin)
        got = tl._apply_rope(torch.from_numpy(x), tcos, tsin)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5

    @pytest.mark.parametrize("offset", [False, True])
    def test_rms_norm_bf16(self, offset):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, 4, 64)).astype(np.float32)
        w = (rng.standard_normal(64) * 0.1).astype(np.float32)
        want = jl._rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                            1e-6, offset=offset)
        got = tl._rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                           1e-6, offset=offset)
        assert got.dtype == torch.bfloat16
        # one bf16 ulp at |values| < 4
        assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() <= 1.6e-2

    def test_gemma_offset_not_quantized_away(self):
        x = torch.full((1, 4, 64), 3.0, dtype=torch.bfloat16)
        small = tl._rms_norm(x, torch.full((64,), 0.01, dtype=torch.bfloat16), 1e-6, True)
        plain = tl._rms_norm(x, torch.zeros(64, dtype=torch.bfloat16), 1e-6, True)
        assert float((small.float() - plain.float()).abs().max()) > 0


class TestBridge:
    def test_bf16_weights_cross_exactly(self):
        jc, jp, tc, tp = bridged(10, "bf16")
        want = np.asarray(jp["layers"][1]["wq"]).astype(np.float32)
        got = tp["layers"][1]["wq"]
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), want)
        assert set(tp) == set(jp) and set(tp["layers"][0]) == set(jp["layers"][0])

    def test_quantized_leaves_raise(self):
        """Quantized leaves cross the bridge (tests/test_torch_quantize.py
        holds them bit for bit), a ``moe`` node among them: its router
        stays f32 and its int8 expert stacks become QuantizedExpertStack
        (the reference's node has QuantizedLinear's fields, over a 3-D
        q). An unrecognised leaf still raises."""
        from nos_tpu.models.quantize import quantize_params
        from nos_tpu_torch.models.quantize import QuantizedExpertStack

        jc, jp, tc, _ = bridged(11, n_experts=4)
        tree = jax.tree.map(np.asarray, quantize_params(jp))
        ported = params_from_numpy(tree, tc, device="cpu")
        assert ported["embed"].q.dtype == torch.int8
        node = ported["layers"][0]["moe"]
        assert node["router"].dtype == torch.float32
        assert np.array_equal(node["router"].numpy(), tree["layers"][0]["moe"]["router"])
        stack = node["w_up"]
        assert isinstance(stack, QuantizedExpertStack)
        assert stack.q.dtype == torch.int8 and stack.q.shape == (4, 64, 128)
        assert stack.scale.dtype == torch.float32 and stack.scale.shape == (4, 128)
        tree["layers"][0]["wq"] = object()
        with pytest.raises(TypeError, match="layers\\[0\\].wq"):
            params_from_numpy(tree, tc, device="cpu")

    def test_out_of_slice_options_raise(self):
        jc, jp, tc, tp = bridged(12)
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(TypeError, match="DeviceMesh"):
            tl.llama_forward(tp, toks, tc, mesh=object())
        # routed MoE is in the slice: init and forward run
        moe = tl.tiny_config(n_experts=4, dtype=torch.float32)
        moe_params = tl.init_llama_params(moe, 0, device="cpu")
        assert "moe" in moe_params["layers"][0] and "w_up" not in moe_params["layers"][0]
        logits = tl.llama_forward(moe_params, toks, moe)
        assert logits.shape == (1, 4, moe.vocab_size) and bool(torch.isfinite(logits).all())
        with pytest.raises(TypeError, match="DeviceMesh"):
            tl.llama_forward(moe_params, toks, moe, mesh=object())
