"""Port training path (llama_loss, make_train_step, bridge) against JAX.

Weights come from the reference's own init and cross through the bridge
as numpy arrays; token ids come from numpy with a fixed seed. The JAX
side runs ``make_train_step`` on a one-device CPU mesh; with
``attention="flash"`` its Pallas kernels run in interpret mode (the
model picks interpret mode on the CPU backend).

Tolerances, f32: the loss to 1e-5 and gradients to 1e-4 (the same
arithmetic, only matmul and key-tile summation orders differ; observed
about 1e-6 and 4e-7); parameters after SGD / AdamW steps to 1e-5
(an update of lr * v moves them by about 1e-3, so the gradient noise
above shrinks by that factor again). bf16: see the test's docstring.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from nos_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.parallel import make_train_step
from nos_tpu_torch.models.llama import tree_leaves

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def bridged(seed=0, dtype="f32", **overrides):
    """(jax config, jax params, port config, port params) on shared weights."""
    jdt, tdt = _DTYPES[dtype]
    jc = jl.tiny_config(dtype=jdt, **overrides)
    tc = tl.tiny_config(dtype=tdt, **overrides)
    jp = jl.init_llama_params(jax.random.key(seed), jc)
    return jc, jp, tc, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def tokens_np(seed, b=2, s=16, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def one_device_mesh():
    return mesh_from_devices((1, 1), ("dp", "tp"), jax.devices()[:1])


def max_leaf_diff(port_tree, jax_tree) -> float:
    """Largest |port - jax| over matching leaves, in f32."""
    got = tree_leaves(port_tree)
    # jax.tree.leaves sorts dict keys, the port's tree_leaves keeps their
    # order: bridge the reference's tree first (f32 holds bf16 exactly)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jax_tree),
                                         tl.tiny_config(dtype=torch.float32),
                                         device="cpu"))
    assert len(got) == len(want)
    return max(float((g.detach().float() - w.float()).abs().max()) for g, w in zip(got, want))


class TestLoss:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    @pytest.mark.parametrize("remat", [False, True])
    def test_value_and_grads_match_jax(self, attention, remat):
        jc, jp, tc, tp = bridged(0, attention=attention, remat=remat)
        toks = tokens_np(1)
        want_loss, want_grads = jax.value_and_grad(
            lambda p: jl.llama_loss(p, jnp.asarray(toks), jc)
        )(jp)
        leaves = tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = tl.llama_loss(tp, torch.from_numpy(toks), tc)
        grads = torch.autograd.grad(loss, leaves)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL
        grad_tree = jax.tree.map(np.asarray, want_grads)
        want = tree_leaves(params_from_numpy(grad_tree, tc, device="cpu"))
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= GRAD_ATOL

    def test_with_aux_is_zero_for_dense_models(self):
        _, _, tc, tp = bridged(2)
        toks = torch.from_numpy(tokens_np(2))
        logits, aux = tl.llama_forward(tp, toks, tc, with_aux=True)
        assert aux.dim() == 0 and float(aux) == 0.0
        assert torch.equal(logits, tl.llama_forward(tp, toks, tc))


def run_both(steps, jax_kwargs, port_kwargs, dtype="f32", seed=3, b=2, **cfg):
    """``steps`` train steps from the same weights on the same batches:
    (jax losses, jax params, port losses, port params)."""
    jc, jp, tc, tp = bridged(seed, dtype, **cfg)
    batches = [tokens_np(seed + 10, b=b)] * steps  # one batch: the loss falls
    jstep, jshard = jax_make_train_step(one_device_mesh(), jc, **jax_kwargs)
    pstep, pshard = make_train_step(None, tc, device="cpu", **port_kwargs)
    jstate, pstate = jshard(jp), pshard(tp)
    jl_, pl_ = [], []
    for toks in batches:
        jstate, loss = jstep(jstate, jnp.asarray(toks))
        jl_.append(float(loss))
        pstate, loss = pstep(pstate, torch.from_numpy(toks))
        assert loss.dim() == 0
        pl_.append(float(loss))
    return jl_, jstate[0], pl_, pstate[0]


class TestTrainStep:
    def test_three_sgd_steps_flash_remat(self):
        jl_, jp, pl_, pp = run_both(
            3, dict(learning_rate=0.05), dict(learning_rate=0.05),
            attention="flash", remat=True,
        )
        assert np.abs(np.array(jl_) - np.array(pl_)).max() <= LOSS_ATOL
        assert max_leaf_diff(pp, jp) <= PARAM_ATOL
        assert pl_[2] < pl_[0]  # it trains

    def test_one_bf16_sgd_step(self):
        """bf16 params: both sides round the velocity and the update to
        bf16, but XLA may fuse `p - lr * (m * v + g)` and round once where
        eager torch rounds after every op, and the bf16 model's own
        activations round at other points (tests/test_torch_llama.py
        holds bf16 logits to 1e-1). The loss agrees to 2e-2 and each
        parameter to within two bf16 ulps of its own magnitude plus two of
        the update's (|diff| <= 2^-7 |p| + 5e-5: the step lr * v is at
        most 3.2e-3 here, and near-zero weights are all update)."""
        jl_, jp, pl_, pp = run_both(
            1, dict(learning_rate=0.01), dict(learning_rate=0.01), dtype="bf16",
            attention="flash", remat=True,
        )
        assert abs(jl_[0] - pl_[0]) <= 2e-2
        want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tl.tiny_config(dtype=torch.float32),
                                             device="cpu"))
        for g, w in zip(tree_leaves(pp), want):
            assert g.dtype == torch.bfloat16
            assert bool(((g.detach().float() - w).abs() <= 2**-7 * w.abs() + 5e-5).all())

    def test_adamw_factory_matches_optax(self):
        """eps sits well above the gradients' summation noise (about 4e-7):
        Adam divides each gradient by its own magnitude, so with a tiny
        eps a gradient at the noise level would take a full +-lr step in
        a direction set by the noise. eps 1e-3 still separates eps from
        eps_root, and the decoupled decay moves every weight by lr * wd *
        |p| (up to 3e-4 here), thirty times the tolerance."""
        import optax

        hp = dict(learning_rate=1e-2, b1=0.8, b2=0.95, eps=1e-3, weight_decay=0.1)
        factory = functools.partial(
            torch.optim.AdamW, lr=hp["learning_rate"], betas=(hp["b1"], hp["b2"]),
            eps=hp["eps"], weight_decay=hp["weight_decay"],
        )
        jl_, jp, pl_, pp = run_both(
            2, dict(optimizer=optax.adamw(**hp)), dict(optimizer=factory),
        )
        assert np.abs(np.array(jl_) - np.array(pl_)).max() <= LOSS_ATOL
        assert max_leaf_diff(pp, jp) <= PARAM_ATOL
        assert pl_[1] < pl_[0]

    def test_accumulation_matches_jax_and_one_big_batch(self):
        jl_, jp, pl_, pp = run_both(
            2, dict(accum_steps=2), dict(accum_steps=2), b=4,
        )
        assert np.abs(np.array(jl_) - np.array(pl_)).max() <= LOSS_ATOL
        assert max_leaf_diff(pp, jp) <= PARAM_ATOL
        # equal micro-batches: the same step as one batch of 4
        _, _, tc, tp = bridged(3)
        step1, shard1 = make_train_step(None, tc, device="cpu")
        step2, shard2 = make_train_step(None, tc, device="cpu", accum_steps=2)
        s1, s2 = shard1(tp), shard2(tp)
        toks = torch.from_numpy(tokens_np(13, b=4))
        s1, l1 = step1(s1, toks)
        s2, l2 = step2(s2, toks)
        assert abs(float(l1) - float(l2)) <= LOSS_ATOL
        for a, b in zip(tree_leaves(s1[0]), tree_leaves(s2[0])):
            assert float((a - b).detach().abs().max()) <= PARAM_ATOL

    def test_shard_state_copies_unless_donated(self):
        _, _, tc, tp = bridged(4)
        step, shard = make_train_step(None, tc, device="cpu")
        before = tp["layers"][0]["wq"].clone()
        state = shard(tp)
        assert all(float(v.abs().max()) == 0 for v in tree_leaves(state[1]))
        state, _ = step(state, torch.from_numpy(tokens_np(4)))
        assert torch.equal(tp["layers"][0]["wq"], before)  # caller's copy untouched
        assert not torch.equal(state[0]["layers"][0]["wq"], before)
        donated = shard(tp, donate=True)
        assert donated[0]["layers"][0]["wq"].data_ptr() == tp["layers"][0]["wq"].data_ptr()

    def test_contract_errors(self):
        _, _, tc, tp = bridged(5)
        with pytest.raises(ValueError, match="optimizer"):
            make_train_step(None, tc, learning_rate=0.1, device="cpu",
                            optimizer=torch.optim.SGD)
        with pytest.raises(ValueError, match="optimizer"):
            make_train_step(None, tc, momentum=0.5, device="cpu",
                            optimizer=torch.optim.SGD)
        with pytest.raises(ValueError, match="accum_steps"):
            make_train_step(None, tc, accum_steps=0, device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            make_train_step(object(), tc, device="cpu")
        step, shard = make_train_step(None, tc, accum_steps=3, device="cpu")
        with pytest.raises(ValueError, match="divisible"):
            step(shard(tp), torch.zeros((4, 16), dtype=torch.long))


class TestBridgeRoundTrip:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_numpy_to_port_to_numpy_is_exact(self, dtype):
        jc, jp, tc, tp = bridged(6, dtype)
        tree = jax.tree.map(np.asarray, jp)
        back = params_to_numpy(tp)
        assert set(back) == set(tree)
        assert back["layers"][1]["wq"].dtype == tree["layers"][1]["wq"].dtype
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))

    def test_velocity_tree_crosses_as_params(self):
        _, _, tc, tp = bridged(7)
        step, shard = make_train_step(None, tc, device="cpu")
        state, _ = step(shard(tp), torch.from_numpy(tokens_np(7)))
        velocity = params_to_numpy(state[1])
        again = params_from_numpy(velocity, tc, device="cpu")
        for a, b in zip(tree_leaves(again), tree_leaves(state[1])):
            assert torch.equal(a, b)
