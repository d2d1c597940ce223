"""Port flash-attention gradients (nos_tpu_torch.ops) against the JAX kernels.

On the CPU the port's backward runs ``flash_attention_bwd_reference``,
the plain version of its dQ and dK/dV kernels; the JAX side runs the
Pallas backward kernels in interpret mode, as
tests/ops/test_flash_attention.py does. Inputs come from numpy with a
fixed seed and go to both.

Tolerances: f32 gradients agree to atol 1e-4, the reference's own bar
for flash gradients (tests/ops/test_flash_attention.py): the same block
math, only the summation order differs (key tiles, the group sum). bf16
gradients agree to atol 5e-2: both round p and dS to bf16 before their
second products and the gradients to bf16 at the end, but the f32 values
being rounded differ in their last bits, so an element on a rounding
edge can move by one bf16 ulp (2^-8 relative) of values of order 1-4.
The CUDA kernels are held against the plain version on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.ops import flash_attention as jax_flash
from nos_tpu.ops.flash_attention import flash_block_grads as jax_block_grads
import nos_tpu_torch.ops.flash_attention as fa
from nos_tpu_torch.models.llama import gqa_dense_attention

F32_ATOL = 1e-4
BF16_ATOL = 5e-2


def arrays(seed, b=1, s=32, hq=4, hkv=2, hd=8, skv=None):
    """q, k, v and an output cotangent do, from numpy."""
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (
        rng.standard_normal((b, s, hq, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
        rng.standard_normal((b, s, hq, hd), dtype=np.float32),
    )


def close(got_torch, want_jax, atol):
    got = got_torch.float().numpy()
    want = np.asarray(jnp.asarray(want_jax, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= atol, err


def jax_grads(q, k, v, do, dtype=jnp.float32, **kw):
    """jax.grad of sum(flash_attention(q, k, v) * do), interpret mode."""
    q, k, v = (jnp.asarray(x, dtype) for x in (q, k, v))
    do = jnp.asarray(do, jnp.float32)

    def f(q, k, v):
        out = jax_flash(q, k, v, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * do)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def port_grads(q, k, v, do, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(q, k, v, **kw)
    (out.float() * torch.from_numpy(do)).sum().backward()
    return q.grad, k.grad, v.grad


class TestFlashGradsMatchJax:
    @pytest.mark.parametrize(
        "name,shape,kw",
        [
            ("causal", dict(b=2, s=64, hq=4, hkv=4, hd=16), dict(causal=True)),
            ("noncausal", dict(b=2, s=64, hq=4, hkv=4, hd=16), dict(causal=False)),
            ("gqa", dict(s=32, hq=8, hkv=2, hd=8), {}),
            ("mqa", dict(s=32, hq=4, hkv=1, hd=8), {}),
            ("window", dict(s=64, hq=4, hkv=2, hd=16), dict(window=5)),
            ("wide_window", dict(s=64, hq=4, hkv=2, hd=16), dict(window=40)),
            # S not a multiple of the kernel's 64: the reference clamps its
            # blocks to divisors of S, the port masks the ragged edge
            ("ragged", dict(s=40, hq=4, hkv=2, hd=8), {}),
        ],
    )
    def test_f32(self, name, shape, kw):
        q, k, v, do = arrays(sum(map(ord, name)), **shape)
        want = jax_grads(q, k, v, do, blk_q=16, blk_k=16, **kw)
        got = port_grads(q, k, v, do, **kw)
        for g, w in zip(got, want):
            close(g, w, F32_ATOL)

    def test_bf16(self):
        q, k, v, do = arrays(31, s=32, hq=4, hkv=2, hd=16)
        want = jax_grads(q, k, v, do, jnp.bfloat16, blk_q=16, blk_k=16)
        got = port_grads(q, k, v, do, torch.bfloat16)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            close(g, w, BF16_ATOL)


def block_forward(q, k, v, q_off, kv_off, window=None):
    """(out, lse) of one block from the port, as numpy (fed to both)."""
    out, lse = fa.flash_attention_block(
        *(torch.from_numpy(x) for x in (q, k, v)), q_off, kv_off, window=window
    )
    return out.numpy(), lse.numpy()


class TestBlockGrads:
    @pytest.mark.parametrize("window", [None, 9])
    def test_at_offsets_with_f32_grads_and_delta(self, window):
        q, k, v, do = arrays(40, s=24, hq=4, hkv=2, hd=8, skv=40)
        out, lse = block_forward(q, k, v, 30, 4, window)
        delta = fa.flash_delta(torch.from_numpy(do), torch.from_numpy(out)).numpy()
        want = jax_block_grads(
            *(jnp.asarray(x) for x in (q, k, v, out, lse, do)), 30, 4,
            interpret=True, grad_dtype=jnp.float32, delta=jnp.asarray(delta),
            window=window,
        )
        got = fa.flash_block_grads(
            *(torch.from_numpy(x) for x in (q, k, v, out, lse, do)), 30, 4,
            grad_dtype=torch.float32, delta=torch.from_numpy(delta), window=window,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, F32_ATOL)

    def test_bf16_inputs_with_f32_grads(self):
        q, k, v, do = arrays(41, s=32, hq=4, hkv=2, hd=16)
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        out, lse = fa.flash_attention_block(tq, tk, tv, 0, 0)
        tdo = torch.from_numpy(do).bfloat16()
        got = fa.flash_block_grads(tq, tk, tv, out, lse, tdo, 0, 0,
                                   grad_dtype=torch.float32)
        to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
        want = jax_block_grads(
            to_j(tq), to_j(tk), to_j(tv), to_j(out), jnp.asarray(lse.numpy()),
            to_j(tdo), 0, 0, interpret=True, grad_dtype=jnp.float32,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, BF16_ATOL)

    def test_two_halves_sum_to_full_grads(self):
        q, k, v, do = (torch.from_numpy(x) for x in arrays(42, s=32, hq=4, hkv=2, hd=8))
        half = 16
        o1, l1 = fa.flash_attention_block(q, k[:, :half], v[:, :half], 0, 0)
        o2, l2 = fa.flash_attention_block(q, k[:, half:], v[:, half:], 0, half)
        out, lse = fa.merge_flash_partials(o1, l1, o2, l2)
        dq1, dk1, dv1 = fa.flash_block_grads(q, k[:, :half], v[:, :half], out, lse, do, 0, 0)
        dq2, dk2, dv2 = fa.flash_block_grads(q, k[:, half:], v[:, half:], out, lse, do, 0, half)
        gq, gk, gv = port_grads(*(x.numpy() for x in (q, k, v, do)))
        assert float((dq1 + dq2 - gq).abs().max()) <= F32_ATOL
        assert float((torch.cat([dk1, dk2], 1) - gk).abs().max()) <= F32_ATOL
        assert float((torch.cat([dv1, dv2], 1) - gv).abs().max()) <= F32_ATOL
        # and the full grads are the reference kernels' grads
        want = jax_grads(*(x.numpy() for x in (q, k, v, do)), blk_q=16, blk_k=16)
        for g, w in zip((gq, gk, gv), want):
            close(g, w, F32_ATOL)

    def test_fully_future_block_gives_zero_grads(self):
        q, k, v, do = (torch.from_numpy(x) for x in arrays(43, s=16, hq=4, hkv=2, hd=8))
        # lse of this block alone (all -inf) and of a real attention (finite)
        _, lse_empty = fa.flash_attention_block(q, k, v, 0, 1000)
        out, lse_full = fa.flash_attention_block(q, k, v, 0, 0)
        for lse in (lse_empty, lse_full):
            grads = fa.flash_block_grads(q, k, v, out, lse, do, 0, 1000)
            assert all(bool(torch.all(g == 0)) for g in grads)
        jgrads = jax_block_grads(
            *(jnp.asarray(x.numpy()) for x in (q, k, v, out, lse_empty, do)),
            0, 1000, interpret=True,
        )
        assert all(np.all(np.asarray(g) == 0) for g in jgrads)


# Scaled-down versions of the card's backward edge cases
# (tests/test_torch_cuda.py), whose plain version is what the card
# compares the kernels against: S around a 16-row tile, Sq != Skv with
# offsets off the tile grid and a window, Hq = Hkv, Skv = 1.
_EDGE_CASES = [
    ("ragged_s15", dict(s=15), 0, 0, None),
    ("ragged_s17", dict(s=17), 0, 0, None),
    ("ragged_s33", dict(s=33), 0, 0, None),
    ("offsets_off_tile_window", dict(s=24, skv=40), 29, 5, 13),
    ("no_gqa", dict(s=32, hq=4, hkv=4), 0, 0, None),
    ("skv_1", dict(s=12, skv=1), 0, 0, None),
]


class TestBlockGradsAtKernelEdges:
    @pytest.mark.parametrize("name,shape,q_off,kv_off,window", _EDGE_CASES)
    def test_f32(self, name, shape, q_off, kv_off, window):
        q, k, v, do = arrays(sum(map(ord, name)), hd=8, **shape)
        out, lse = block_forward(q, k, v, q_off, kv_off, window)
        want = jax_block_grads(
            *(jnp.asarray(x) for x in (q, k, v, out, lse, do)), q_off, kv_off,
            interpret=True, grad_dtype=jnp.float32, window=window,
        )
        got = fa.flash_block_grads(
            *(torch.from_numpy(x) for x in (q, k, v, out, lse, do)), q_off, kv_off,
            grad_dtype=torch.float32, window=window,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, F32_ATOL)

    @pytest.mark.parametrize("name,shape,q_off,kv_off,window", _EDGE_CASES)
    def test_bf16_inputs(self, name, shape, q_off, kv_off, window):
        q, k, v, do = arrays(sum(map(ord, name)) + 1, hd=16, **shape)
        tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
        out, lse = fa.flash_attention_block(tq, tk, tv, q_off, kv_off, window=window)
        got = fa.flash_block_grads(tq, tk, tv, out, lse, tdo, q_off, kv_off,
                                   grad_dtype=torch.float32, window=window)
        to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
        want = jax_block_grads(
            to_j(tq), to_j(tk), to_j(tv), to_j(out), jnp.asarray(lse.numpy()),
            to_j(tdo), q_off, kv_off, interpret=True, grad_dtype=jnp.float32,
            window=window,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, BF16_ATOL)



class TestHeadDim256:
    """Gemma's head_dim through the plain version of the dQ and dK/dV
    kernels, against the Pallas backward in interpret mode: MQA and GQA
    (the dK/dV group sum), a window, partials at offsets, bf16 inputs
    with f32 and bf16 gradients. Same tolerances."""

    @pytest.mark.parametrize(
        "name,shape,kw",
        [
            ("mqa", dict(s=40, hq=4, hkv=1, hd=256), {}),
            ("gqa_window", dict(s=48, hq=4, hkv=2, hd=256), dict(window=7)),
            ("noncausal", dict(s=24, hq=2, hkv=2, hd=256), dict(causal=False)),
        ],
    )
    def test_f32(self, name, shape, kw):
        q, k, v, do = arrays(sum(map(ord, name)) + 256, **shape)
        want = jax_grads(q, k, v, do, blk_q=8, blk_k=8, **kw)
        got = port_grads(q, k, v, do, **kw)
        for g, w in zip(got, want):
            close(g, w, F32_ATOL)

    def test_bf16(self):
        q, k, v, do = arrays(257, s=32, hq=4, hkv=1, hd=256)
        want = jax_grads(q, k, v, do, jnp.bfloat16, blk_q=16, blk_k=16)
        got = port_grads(q, k, v, do, torch.bfloat16)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            close(g, w, BF16_ATOL)

    @pytest.mark.parametrize("window", [None, 9])
    def test_block_grads_at_offsets_f32(self, window):
        q, k, v, do = arrays(258, s=24, hq=4, hkv=1, hd=256, skv=40)
        out, lse = block_forward(q, k, v, 30, 4, window)
        want = jax_block_grads(
            *(jnp.asarray(x) for x in (q, k, v, out, lse, do)), 30, 4,
            interpret=True, grad_dtype=jnp.float32, window=window,
        )
        got = fa.flash_block_grads(
            *(torch.from_numpy(x) for x in (q, k, v, out, lse, do)), 30, 4,
            grad_dtype=torch.float32, window=window,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, F32_ATOL)

    def test_bf16_inputs_with_f32_grads(self):
        q, k, v, do = arrays(259, s=40, hq=4, hkv=1, hd=256)
        tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
        out, lse = fa.flash_attention_block(tq, tk, tv, 0, 0)
        got = fa.flash_block_grads(tq, tk, tv, out, lse, tdo, 0, 0,
                                   grad_dtype=torch.float32)
        to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
        want = jax_block_grads(
            to_j(tq), to_j(tk), to_j(tv), to_j(out), jnp.asarray(lse.numpy()),
            to_j(tdo), 0, 0, interpret=True, grad_dtype=jnp.float32,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w, BF16_ATOL)


class TestPlainBackward:
    @pytest.mark.parametrize("window", [None, 6])
    def test_matches_autograd_through_dense_attention(self, window):
        """An independent check of the plain version: autograd of the
        model's dense GQA attention (different code, same function)."""
        q, k, v, do = (torch.from_numpy(x) for x in arrays(50, s=40, hq=8, hkv=2, hd=16))
        qd, kd, vd = (x.clone().requires_grad_(True) for x in (q, k, v))
        pos = torch.arange(40)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask = mask & (pos[:, None] - pos[None, :] < window)
        (gqa_dense_attention(qd, kd, vd, mask) * do).sum().backward()
        out, lse = fa.flash_attention_reference(q, k, v, window=window)
        got = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, window=window)
        for g, w in zip(got, (qd.grad, kd.grad, vd.grad)):
            assert float((g - w).abs().max()) <= F32_ATOL

    def test_key_tiling_does_not_change_the_result(self):
        q, k, v, do = (torch.from_numpy(x) for x in arrays(51, s=40, hq=4, hkv=2, hd=8))
        out, lse = fa.flash_attention_reference(q, k, v)
        a = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, blk_k=8)
        b = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, blk_k=64)
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-5

    def test_rejects_a_cotangent_of_another_shape(self):
        q, k, v, do = (torch.from_numpy(x) for x in arrays(53, s=16))
        out, lse = fa.flash_attention_block(q, k, v, 0, 0)
        with pytest.raises(ValueError, match="q's shape"):
            fa.flash_block_grads(q, k, v, out, lse, do[:, :8], 0, 0)

    def test_only_requested_grads(self):
        q, k, v, do = (torch.from_numpy(x) for x in arrays(52, s=16))
        qg = q.clone().requires_grad_(True)
        fa.flash_attention(qg, k, v).mul(do).sum().backward()
        assert qg.grad is not None and k.grad is None and v.grad is None


def test_cpu_runs_never_count_as_launches():
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    q, k, v, do = arrays(60, s=16)
    port_grads(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_block(tq, tk, tv, 0, 0)
    fa.flash_block_grads(tq, tk, tv, out, lse, tdo, 0, 0)
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == before
