"""Port routed MoE (nos_tpu_torch.models.moe) against JAX.

The same f32 inputs (numpy seeds) and the same expert weights (the
reference's ``init_moe_params``, carried over as numpy) go through
``nos_tpu.models.moe.moe_mlp`` and the port's. Config: d 16, d_ff 32,
4 experts, top-2.

Tolerances, f32: outputs and the aux loss within 1e-6 (the same
arithmetic; products of 16 and 32 terms sum in another order, observed
about 1e-7); gradients with respect to x, the router and the stacks
within 1e-5 of ``jax.grad`` (a few such sums chained). Routing itself is
exact: the same experts, the same kept pairs. Quantized stacks: int8
values and scales bit-identical, outputs within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import moe as jm
from nos_tpu.models import quantize as jq
from nos_tpu_torch.models import moe as tm
from nos_tpu_torch.models import quantize as tq

OUT_ATOL = 1e-6
GRAD_ATOL = 1e-5
_STACKS = ("w_gate", "w_up", "w_down")


def configs(factor=1.25, n_experts=4):
    kw = dict(d_model=16, d_ff=32, n_experts=n_experts, top_k=2, capacity_factor=factor)
    return (jm.MoeConfig(dtype=jnp.float32, **kw),
            tm.MoeConfig(dtype=torch.float32, **kw))


def moe_params(seed=0, n_experts=4, zero_router=False):
    """(jax params, numpy params) from the reference's init."""
    jc, _ = configs(n_experts=n_experts)
    jp = jm.init_moe_params(jax.random.key(seed), jc)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    return jp, {k: np.array(v) for k, v in jp.items()}


def port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def inputs(seed, b=2, s=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, 16)).astype(np.float32)
    mask = rng.random((b, s)) < 0.7
    return x, mask


class TestMoeMlp:
    @pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
    @pytest.mark.parametrize("masked", [False, True])
    def test_output_and_aux_match_reference(self, factor, masked):
        """Factor 1.0 overflows (16 tokens x 2 over 4 experts of 8 slots:
        any skew drops pairs), 8.0 never does."""
        jc, tc = configs(factor)
        jp, npp = moe_params(1)
        x, mask = inputs(2)
        m = mask if masked else None
        want, want_aux = jm.moe_mlp(jp, jnp.asarray(x), jc, return_aux=True,
                                    token_mask=None if m is None else jnp.asarray(m))
        got, aux = tm.moe_mlp(port(npp), torch.from_numpy(x), tc, return_aux=True,
                              token_mask=None if m is None else torch.from_numpy(m))
        assert got.shape == x.shape and aux.dim() == 0 and aux.dtype == torch.float32
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= OUT_ATOL
        assert abs(float(aux) - float(want_aux)) <= OUT_ATOL
        plain = tm.moe_mlp(port(npp), torch.from_numpy(x), tc,
                           token_mask=None if m is None else torch.from_numpy(m))
        assert torch.equal(plain, got)
        if masked:  # masked tokens output exactly zero
            assert bool((got[torch.from_numpy(~mask)] == 0).all())

    def test_overflow_drops_pairs_like_the_reference(self):
        """Capacity 1: each expert keeps its first pair, the rest output
        only what their other expert gave (or zero)."""
        jc, tc = configs(0.1)
        jp, npp = moe_params(3)
        x, _ = inputs(4, b=1, s=6)
        want = np.asarray(jm.moe_mlp(jp, jnp.asarray(x), jc))
        got = tm.moe_mlp(port(npp), torch.from_numpy(x), tc).numpy()
        assert tm.capacity_per_expert(6, tc) == 1
        assert np.abs(got - want).max() <= OUT_ATOL
        assert (np.abs(got).sum(-1) == 0).any()  # some token lost both experts

    def test_zero_router_ties_pick_the_lowest_experts(self):
        """Every row ties: jax.lax.top_k returns experts [0, 1] (lowest
        index first), where torch.topk may not. All tokens race for
        experts 0 and 1, so capacity binds too."""
        jc, tc = configs(1.25, n_experts=8)
        jp, npp = moe_params(5, n_experts=8, zero_router=True)
        x, _ = inputs(6)
        assert np.asarray(jax.lax.top_k(jnp.full((3, 8), 0.125), 2)[1]).tolist() == [[0, 1]] * 3
        top_e = tm._route(torch.from_numpy(x).reshape(16, 16), port(npp)["router"], tc)[1]
        assert top_e.tolist() == [[0, 1]] * 16
        want, want_aux = jm.moe_mlp(jp, jnp.asarray(x), jc, return_aux=True)
        got, aux = tm.moe_mlp(port(npp), torch.from_numpy(x), tc, return_aux=True)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= OUT_ATOL
        assert abs(float(aux) - float(want_aux)) <= OUT_ATOL
        # a partial tie: [.1, .3, .3, .3, 0, ...] picks [1, 2] in both
        probs = np.array([[.1, .3, .3, .3, 0, 0, 0, 0]], np.float32)
        j_top = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
        t_top = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                           stable=True)[1][:, :2]
        assert j_top.tolist() == t_top.tolist() == [[1, 2]]

    def test_dropped_pairs_sharing_a_slot_keep_the_kept_token(self):
        """Capacity 1 with every token on experts 0 and 1: the first
        token holds slot 0 of both, and the dropped pairs of the others
        land on the same slot with zero weight. The first token's output
        is its own expert mix, untouched by the collisions."""
        _, tc = configs(0.01)
        _, npp = moe_params(7, zero_router=True)
        params = port(npp)
        x = torch.from_numpy(inputs(8, b=1, s=5)[0])
        out = tm.moe_mlp(params, x, tc)
        assert tm.capacity_per_expert(5, tc) == 1
        h = x[0, :1]
        solo = sum(0.5 * ((torch.nn.functional.silu(h @ params["w_gate"][e])
                          * (h @ params["w_up"][e])) @ params["w_down"][e])
                   for e in (0, 1))
        assert float((out[0, 0] - solo[0]).abs().max()) <= OUT_ATOL
        assert bool((out[0, 1:] == 0).all())

    def test_gradients_match_jax_grad(self):
        jc, tc = configs(1.0)
        jp, npp = moe_params(9)
        x, mask = inputs(10)

        def j_loss(p, xx):
            out, aux = jm.moe_mlp(p, xx, jc, return_aux=True, token_mask=jnp.asarray(mask))
            return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape))) + aux

        jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
        tp = {k: v.requires_grad_(True) for k, v in port(npp).items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        out, aux = tm.moe_mlp(tp, tx, tc, return_aux=True, token_mask=torch.from_numpy(mask))
        weight = torch.cos(torch.arange(out.numel(), dtype=torch.float32)).reshape(out.shape)
        loss = (out * weight).sum() + aux
        grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in ("router",) + _STACKS])
        wants = [jg_x] + [jg_p[k] for k in ("router",) + _STACKS]
        for g, w in zip(grads, wants):
            assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= GRAD_ATOL
        assert float(grads[1].abs().max()) > 0  # the router learns through pair_w

    def test_mesh_raises(self):
        _, tc = configs()
        _, npp = moe_params(0)
        with pytest.raises(TypeError, match="DeviceMesh"):
            tm.moe_mlp(port(npp), torch.zeros(1, 2, 16), tc, mesh=object())

    def test_init_is_seeded_with_an_f32_router(self):
        tc = dataclasses.replace(configs()[1], dtype=torch.bfloat16)
        a = tm.init_moe_params(torch.Generator().manual_seed(3), tc)
        b = tm.init_moe_params(torch.Generator().manual_seed(3), tc)
        assert a["router"].dtype == torch.float32 and a["router"].shape == (16, 4)
        assert a["w_down"].dtype == torch.bfloat16 and a["w_down"].shape == (4, 32, 16)
        assert all(torch.equal(a[k], b[k]) for k in a)


class TestQuantizedStacks:
    def test_quantize_expert_stack_is_bit_identical(self):
        _, npp = moe_params(11)
        for key in _STACKS:
            want = jq.quantize_expert_stack(jnp.asarray(npp[key]))
            got = tq.quantize_expert_stack(torch.from_numpy(npp[key]))
            assert got.q.dtype == torch.int8 and got.q.shape == npp[key].shape
            assert np.array_equal(got.q.numpy(), np.asarray(want.q))
            assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
            back = tq.dequantize_params({"s": got}, torch.float32)["s"]
            want_back = jq.dequantize_params(want, jnp.float32)
            assert np.array_equal(back.numpy(), np.asarray(want_back))

    @pytest.mark.parametrize("factor", [1.0, 8.0])
    def test_moe_on_int8_stacks_matches_reference(self, factor):
        jc, tc = configs(factor)
        jp, npp = moe_params(12)
        jq_p = dict(jp, **{k: jq.quantize_expert_stack(jp[k]) for k in _STACKS})
        tq_p = dict(port(npp), **{k: tq.quantize_expert_stack(torch.from_numpy(npp[k]))
                                  for k in _STACKS})
        x, mask = inputs(13)
        want = np.asarray(jm.moe_mlp(jq_p, jnp.asarray(x), jc, token_mask=jnp.asarray(mask)))
        got = tm.moe_mlp(tq_p, torch.from_numpy(x), tc, token_mask=torch.from_numpy(mask))
        assert float(np.abs(got.numpy() - want).max()) <= OUT_ATOL
