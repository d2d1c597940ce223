"""Port flash attention (nos_tpu_torch.ops) against the JAX kernel.

On the CPU the port runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/ops/test_flash_attention.py
does. Inputs come from numpy with a fixed seed and go to both.

Tolerances: f32 cases compare at atol 1e-5 — the same online softmax
over different key tilings, so only the summation order differs. bf16
cases compare at atol 2e-2 — both round O to bf16 once at the end, so
they differ by at most about one bf16 ulp of values of order 1. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.ops import flash_attention as jax_flash
from nos_tpu.ops.flash_attention import (
    flash_attention_block as jax_block,
    merge_flash_partials as jax_merge,
)
import nos_tpu_torch.ops.flash_attention as fa

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def qkv_np(seed, b=1, s=32, hq=4, hkv=2, hd=8, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (
        rng.standard_normal((b, s, hq, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
    )


def to_jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def to_torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def close(got_torch, want_jax, atol):
    got = got_torch.float().numpy()
    want = np.asarray(jnp.asarray(want_jax, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= atol, err


class TestForwardParity:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax_kernel(self, causal):
        arrs = qkv_np(0, b=2, s=64, hq=4, hkv=4, hd=16)
        want = jax_flash(*to_jax(arrs), causal=causal, blk_q=16, blk_k=16,
                         interpret=True)
        got = fa.flash_attention(*to_torch(arrs), causal=causal, blk_k=16)
        close(got, want, F32_ATOL)

    def test_gqa_grouping(self):
        arrs = qkv_np(1, s=32, hq=8, hkv=2, hd=8)
        want = jax_flash(*to_jax(arrs), blk_q=8, blk_k=8, interpret=True)
        close(fa.flash_attention(*to_torch(arrs), blk_k=8), want, F32_ATOL)

    def test_single_block(self):
        arrs = qkv_np(2, s=8, hq=2, hkv=2, hd=8)
        want = jax_flash(*to_jax(arrs), interpret=True)
        close(fa.flash_attention(*to_torch(arrs)), want, F32_ATOL)

    def test_bfloat16_inputs(self):
        arrs = qkv_np(3, s=32, hq=2, hkv=2, hd=8)
        want = jax_flash(*to_jax(arrs, jnp.bfloat16), blk_q=16, blk_k=16,
                         interpret=True)
        got = fa.flash_attention(*to_torch(arrs, torch.bfloat16), blk_k=16)
        assert got.dtype == torch.bfloat16
        close(got, want, BF16_ATOL)

    @pytest.mark.parametrize("s", [24, 37])
    def test_odd_sequence_length(self, s):
        # the reference clamps its blocks to divisors of S; the port's
        # tiles run past the ragged edge and mask it: same outputs
        arrs = qkv_np(5, s=s, hq=4, hkv=2, hd=8)
        want = jax_flash(*to_jax(arrs), blk_q=16, blk_k=16, interpret=True)
        close(fa.flash_attention(*to_torch(arrs), blk_k=16), want, F32_ATOL)

    @pytest.mark.parametrize("window", [3, 5, 16, 100])
    def test_sliding_window(self, window):
        arrs = qkv_np(60, s=64, hq=4, hkv=2, hd=16)
        want = jax_flash(*to_jax(arrs), window=window, blk_q=16, blk_k=16,
                         interpret=True)
        got = fa.flash_attention(*to_torch(arrs), window=window, blk_k=16)
        close(got, want, F32_ATOL)

    def test_key_tiling_does_not_change_the_result(self):
        arrs = to_torch(qkv_np(7, s=40, hq=4, hkv=2, hd=8))
        a = fa.flash_attention(*arrs, blk_k=8)
        b = fa.flash_attention(*arrs, blk_k=64)
        assert float((a - b).abs().max()) <= F32_ATOL

    def test_cpu_runs_never_count_as_launches(self):
        before = fa.LAUNCHES
        fa.flash_attention(*to_torch(qkv_np(8, s=16)))
        assert fa.LAUNCHES == before

    def test_default_blocks_are_the_kernel_tile(self):
        assert fa.default_blocks(None) == (fa.BLOCK_M, fa.BLOCK_N)
        assert fa.default_blocks(512) == (fa.BLOCK_M, fa.BLOCK_N)



class TestHeadDim256:
    """Gemma's head_dim: the card runs it on 64-key tiles, so the plain
    version's default tiling follows (its probabilities round to bf16
    against the running max of the same tiles). Same tolerances."""

    @pytest.mark.parametrize("hq,hkv", [(4, 1), (4, 2), (2, 2)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax_kernel(self, hq, hkv, causal):
        arrs = qkv_np(70 + hq + hkv, s=40, hq=hq, hkv=hkv, hd=256)
        want = jax_flash(*to_jax(arrs), causal=causal, blk_q=8, blk_k=8,
                         interpret=True)
        close(fa.flash_attention(*to_torch(arrs), causal=causal), want, F32_ATOL)

    def test_bfloat16_inputs(self):
        arrs = qkv_np(74, s=96, hq=4, hkv=1, hd=256)
        want = jax_flash(*to_jax(arrs, jnp.bfloat16), blk_q=32, blk_k=32,
                         interpret=True)
        got = fa.flash_attention(*to_torch(arrs, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        close(got, want, BF16_ATOL)

    @pytest.mark.parametrize("window", [None, 9])
    def test_partials_at_offsets_match_jax(self, window):
        arrs = qkv_np(75, s=24, hq=4, hkv=1, hd=256, skv=40)
        want_o, want_l = jax_block(*to_jax(arrs), 30, 4, window=window,
                                   interpret=True)
        got_o, got_l = fa.flash_attention_block(*to_torch(arrs), 30, 4,
                                                window=window)
        close(got_o, want_o, F32_ATOL)
        want_l = torch.from_numpy(np.array(want_l))
        assert torch.equal(torch.isneginf(got_l), torch.isneginf(want_l))
        fin = torch.isfinite(got_l)
        assert float((got_l[fin] - want_l[fin]).abs().max()) <= F32_ATOL

    def test_plain_version_tiles_like_the_kernel(self):
        q, k, v = to_torch(qkv_np(76, s=150, hq=2, hkv=1, hd=256), torch.bfloat16)
        got = fa.flash_attention_reference(q, k, v)
        want = fa.flash_attention_reference(q, k, v, blk_k=64)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # 128-key tiles round p against other running maxima
        other = fa.flash_attention_reference(q, k, v, blk_k=128)[0]
        assert not torch.equal(got[0], other)


class TestKernelOperands:
    """What the kernels' TMA maps are handed (decided on the CPU by the
    wrapper, before any launch)."""

    def test_strided_views_reach_the_kernel_without_a_copy(self):
        q = torch.zeros((2, 4, 40, 64), dtype=torch.bfloat16).transpose(1, 2)
        assert not q.is_contiguous()
        assert fa._tma_ready(q) is q

    def test_expanded_and_unaligned_operands_are_copied(self):
        k = torch.zeros((1, 40, 1, 64), dtype=torch.bfloat16).expand(3, 40, 1, 64)
        got = fa._tma_ready(k)
        assert got is not k and got.is_contiguous()
        odd = torch.zeros((1, 40, 2, 68), dtype=torch.bfloat16)[..., :64]
        assert fa._tma_ready(odd).is_contiguous()

    def test_backward_statistics_get_an_aligned_base(self):
        """The dK/dV kernel reads lse and delta through 1-D TMA maps,
        whose base must be 16-byte aligned: an aligned contiguous tensor
        is handed over as it is, a view at an odd offset is copied."""
        lse = torch.zeros((2, 4, 37, 1))
        assert fa._stats_ready(lse) is lse
        odd = torch.zeros(2 * 4 * 37 + 1)[1:].reshape(2, 4, 37, 1)
        assert odd.data_ptr() % 16 != 0
        got = fa._stats_ready(odd)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, odd)

    def test_tiles_follow_the_kernel(self):
        assert (fa.BLOCK_M, fa.BLOCK_N) == (128, 128)
        fa._check_tiles(None, None)
        fa._check_tiles(128, 128)
        with pytest.raises(ValueError, match="tiles"):
            fa._check_tiles(64, 64)

    @pytest.mark.parametrize("hd,tile", [(64, (128, 128)), (128, (128, 128)),
                                         (256, (128, 64))])
    def test_tiles_per_head_dim(self, hd, tile):
        assert fa.default_blocks(None, hd) == tile
        assert fa.default_blocks(512, hd) == tile
        assert fa.block_n(hd) == tile[1]
        fa._check_tiles(None, None, hd)
        fa._check_tiles(*tile, hd)
        other = 128 if tile[1] == 64 else 64
        with pytest.raises(ValueError, match=f"{tile[0]}x{tile[1]} at head_dim {hd}"):
            fa._check_tiles(tile[0], other, hd)

    @pytest.mark.parametrize("hd", [64, 128, 256])
    def test_kernel_head_dims(self, hd):
        assert hd in fa.KERNEL_HEAD_DIMS
        x = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16)
        fa._check_kernel_operands(hd, q=x, k=x, v=x)

    @pytest.mark.parametrize("hd", [32, 96, 192, 512])
    def test_other_head_dims_are_refused(self, hd):
        """hd 96 (and any head_dim without an instantiation) raises before
        a launch; the CPU's plain version still takes it."""
        x = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_kernel_operands(hd, q=x, k=x, v=x)
        assert fa.flash_attention(x, x, x).shape == x.shape


class TestBlockPartials:
    def test_partials_at_offsets_match_jax(self):
        arrs = qkv_np(20, b=2, s=32, hq=4, hkv=2, hd=16)
        jq, jk, jv = to_jax(arrs)
        tq, tk, tv = to_torch(arrs)
        half = 16
        for sl, off in ((slice(0, half), 0), (slice(half, None), half)):
            jo, jl = jax_block(jq, jk[:, sl], jv[:, sl], 0, off, interpret=True)
            to, tl = fa.flash_attention_block(tq, tk[:, sl], tv[:, sl], 0, off)
            close(to, jo, F32_ATOL)
            # -inf rows (queries before this block) must agree exactly
            assert torch.equal(torch.isneginf(tl), torch.from_numpy(np.isneginf(np.asarray(jl))))
            fin = torch.isfinite(tl)
            err = (tl[fin] - torch.from_numpy(np.array(jl))[fin]).abs().max()
            assert float(err) <= F32_ATOL

    def test_two_halves_merge_to_whole(self):
        arrs = qkv_np(21, b=2, s=32, hq=4, hkv=2, hd=16)
        tq, tk, tv = to_torch(arrs)
        half = 16
        o1, l1 = fa.flash_attention_block(tq, tk[:, :half], tv[:, :half], 0, 0)
        o2, l2 = fa.flash_attention_block(tq, tk[:, half:], tv[:, half:], 0, half)
        out, lse = fa.merge_flash_partials(o1, l1, o2, l2)
        whole, whole_lse = fa.flash_attention_block(tq, tk, tv, 0, 0)
        assert float((out - whole).abs().max()) <= F32_ATOL
        assert float((lse - whole_lse).abs().max()) <= F32_ATOL
        # and the merge itself matches the reference's merge
        jout, jlse = jax_merge(*(jnp.asarray(x.numpy()) for x in (o1, l1, o2, l2)))
        close(out, jout, F32_ATOL)
        close(lse, jlse, F32_ATOL)

    def test_fully_future_block_is_zero_with_neg_inf_lse(self):
        arrs = qkv_np(22, s=16, hq=2, hkv=2, hd=8)
        out, lse = fa.flash_attention_block(*to_torch(arrs), 0, 1000)
        assert torch.all(out == 0)
        assert torch.all(torch.isneginf(lse))
        jo, jl = jax_block(*to_jax(arrs), 0, 1000, interpret=True)
        assert np.all(np.asarray(jo) == 0) and np.all(np.isneginf(np.asarray(jl)))
        # merging an all-empty partial with itself stays empty, not NaN
        mo, ml = fa.merge_flash_partials(out, lse, out, lse)
        assert torch.all(mo == 0) and torch.all(torch.isneginf(ml))

    def test_window_at_offsets_matches_jax(self):
        arrs = qkv_np(23, s=24, hq=4, hkv=2, hd=8, skv=40)
        want_o, want_l = jax_block(*to_jax(arrs), 30, 4, window=9, interpret=True)
        got_o, got_l = fa.flash_attention_block(*to_torch(arrs), 30, 4, window=9)
        close(got_o, want_o, F32_ATOL)
        fin = torch.isfinite(got_l)
        assert torch.equal(fin, torch.from_numpy(np.isfinite(np.asarray(want_l))))


class TestContract:
    def test_rejects_bad_head_grouping(self):
        arrs = to_torch(qkv_np(4, s=24, hq=3, hkv=2, hd=8))
        with pytest.raises(ValueError, match="multiple"):
            fa.flash_attention(*arrs)
        with pytest.raises(ValueError, match="multiple"):
            fa.flash_attention_block(*arrs, 0, 0)

    def test_window_contract(self):
        arrs = to_torch(qkv_np(63, s=16))
        with pytest.raises(ValueError, match="causal"):
            fa.flash_attention(*arrs, causal=False, window=4)
        with pytest.raises(ValueError, match=">= 1"):
            fa.flash_attention(*arrs, window=0)
