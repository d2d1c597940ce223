"""Gemma at head_dim 256 through the port (nos_tpu_torch) against JAX.

Gemma-2B's attention is MQA with a 256 head dim (``gemma_2b_config``), the
head_dim whose flash kernels the port builds with their own tiles. Here a
tiny config keeps Gemma's dialect (gelu gated MLP, (1 + w) RMSNorm,
scaled embeddings, tied unembedding) and its attention shape: one kv
head, ``qk_head_dim=256``, at a narrow width and 2 layers. Weights come
from the reference's own init and cross through the bridge as numpy
arrays; token ids come from numpy with a fixed seed. With
``attention="flash"`` the reference runs its Pallas kernels in interpret
mode and the port its plain versions (the card's kernels are held to
those by tests/test_torch_cuda.py).

Tolerances, as tests/test_torch_llama.py and tests/test_torch_train.py
state them: f32 logits 1e-4, the loss 1e-5, gradients 1e-4 and
parameters after SGD steps 1e-5 (the same arithmetic, only summation
orders differ); bf16 logits 1e-1 (the two frameworks round bf16
intermediates at different points) and probabilities 1e-2 (the test
says why this is wider than the Llama dialect's 3e-3); greedy tokens
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.llama import tree_leaves
from nos_tpu_torch.parallel import make_train_step
import nos_tpu_torch.ops.flash_attention as fa

F32_ATOL = 1e-4
BF16_LOGIT_ATOL = 1e-1
GEMMA_BF16_PROB_ATOL = 1e-2
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# Gemma's dialect and attention shape at a narrow width.
GEMMA_TINY = dict(
    vocab_size=256, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=128,
    hidden_act="gelu", norm_offset=True, scale_embeddings=True,
    tie_embeddings=True, qk_head_dim=256, norm_eps=1e-6,
)


def bridged(seed=0, dtype="f32", **overrides):
    """(jax config, jax params, port config, port params) on shared weights,
    with random norm weights (the init's constants would hide the
    (1 + w) offset)."""
    jdt, tdt = _DTYPES[dtype]
    kw = {**GEMMA_TINY, "attention": "flash", **overrides}
    jc, tc = jl.tiny_config(dtype=jdt, **kw), tl.tiny_config(dtype=tdt, **kw)
    tree = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(seed), jc))
    rng = np.random.default_rng(seed + 100)
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm"):
            layer[key] = (rng.standard_normal(layer[key].shape) * 0.1).astype(
                layer[key].dtype)
    return jc, jax.tree.map(jnp.asarray, tree), tc, params_from_numpy(tree, tc, device="cpu")


def tokens_np(seed, b=2, s=24, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_is_gemma_2b_attention():
    full = tl.gemma_2b_config()
    assert (full.head_dim, full.n_heads, full.n_kv_heads) == (256, 8, 1)
    assert full.head_dim in fa.KERNEL_HEAD_DIMS
    assert fa.default_blocks(None, full.head_dim) == (128, 64)
    _, _, tc, tp = bridged(0)
    assert tc.head_dim == 256 and "lm_head" not in tp
    assert tuple(tp["layers"][0]["wk"].shape) == (64, 256)


class TestForward:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_f32_logits_match_jax(self, attention):
        jc, jp, tc, tp = bridged(1, attention=attention)
        toks = tokens_np(1)
        want = np.array(jl.llama_forward(jp, jnp.asarray(toks), jc))
        got = tl.llama_forward(tp, torch.from_numpy(toks).long(), tc)
        assert got.shape == (2, 24, 256) and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= F32_ATOL

    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_bf16_logits_match_jax(self, attention):
        """Gemma's scaled, tied embedding gives logits up to about 8.5
        here, where a bf16 ulp is 2^-4: the two frameworks' logits differ
        by one such ulp on either attention path (observed 3.1e-2 to
        4.3e-2), which moves a probability by at most p (1 - p) 2^-4 <=
        1.6e-2 (observed 8.1e-3 dense, 7.9e-3 flash): hence 1e-2 on the
        probabilities here, against 3e-3 for the Llama dialect's smaller
        logits."""
        jc, jp, tc, tp = bridged(2, "bf16", attention=attention)
        toks = tokens_np(2, s=80)  # beyond one 64-key tile of the plain version
        want = np.array(jl.llama_forward(jp, jnp.asarray(toks), jc))
        got = tl.llama_forward(tp, torch.from_numpy(toks).long(), tc)
        assert np.abs(got.numpy() - want).max() <= BF16_LOGIT_ATOL
        pg = torch.softmax(got, -1)
        pw = torch.softmax(torch.from_numpy(want), -1)
        assert float((pg - pw).abs().max()) <= GEMMA_BF16_PROB_ATOL

    def test_flash_equals_dense_in_the_port(self):
        _, _, tc, tp = bridged(3)
        toks = torch.from_numpy(tokens_np(3, s=70)).long()
        flash = tl.llama_forward(tp, toks, tc)
        dense = tl.llama_forward(tp, toks, dataclasses.replace(tc, attention="dense"))
        assert float((flash - dense).abs().max()) <= F32_ATOL


class TestLoss:
    @pytest.mark.parametrize("remat", [False, True])
    def test_value_and_grads_match_jax(self, remat):
        jc, jp, tc, tp = bridged(4, remat=remat)
        toks = tokens_np(4)
        want_loss, want_grads = jax.value_and_grad(
            lambda p: jl.llama_loss(p, jnp.asarray(toks), jc))(jp)
        leaves = tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = tl.llama_loss(tp, torch.from_numpy(toks), tc)
        grads = torch.autograd.grad(loss, leaves)
        assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL
        want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, want_grads), tc,
                                             device="cpu"))
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= GRAD_ATOL

    def test_two_sgd_steps_flash_remat_match_jax(self):
        jc, jp, tc, tp = bridged(5, remat=True)
        toks = tokens_np(15)
        mesh = mesh_from_devices((1, 1), ("dp", "tp"), jax.devices()[:1])
        jstep, jshard = jax_make_train_step(mesh, jc, learning_rate=0.05)
        pstep, pshard = make_train_step(None, tc, device="cpu", learning_rate=0.05)
        jstate, pstate = jshard(jp), pshard(tp)
        for _ in range(2):
            jstate, jloss = jstep(jstate, jnp.asarray(toks))
            pstate, ploss = pstep(pstate, torch.from_numpy(toks))
            assert abs(float(ploss) - float(jloss)) <= LOSS_ATOL
        want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jstate[0]), tc,
                                             device="cpu"))
        got = tree_leaves(pstate[0])
        assert max(float((g.detach() - w).abs().max()) for g, w in zip(got, want)) \
            <= PARAM_ATOL


class TestGenerate:
    def test_greedy_token_identical(self):
        jc, jp, tc, tp = bridged(6)
        toks = tokens_np(6, s=20)
        want = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 10))
        got = tg.generate(tp, torch.from_numpy(toks).long(), tc, 10)
        assert got.shape == (2, 10)
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(tg.reference_generate(tp, torch.from_numpy(toks).long(), tc, 10),
                           got)

    def test_prefill_logits_and_cache_match_jax(self):
        jc, jp, tc, tp = bridged(7)
        toks = tokens_np(7, s=12)
        jlog, jcache = jg.prefill(jp, jnp.asarray(toks), jc, 20)
        tlog, tcache = tg.prefill(tp, torch.from_numpy(toks).long(), tc, 20)
        assert np.abs(tlog.numpy() - np.asarray(jlog)).max() <= F32_ATOL
        for tlayer, jlayer in zip(tcache, jcache):
            for key in ("k", "v"):
                assert tlayer[key].shape[-1] == 256
                diff = np.abs(tlayer[key].numpy() - np.asarray(jlayer[key])).max()
                assert diff <= F32_ATOL
