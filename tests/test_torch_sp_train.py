"""Port sequence- and data-parallel Llama (llama_loss and make_train_step
over a DeviceMesh) against the reference on the same mesh shape.

The reference runs ``make_train_step`` in this process on a
``('dp', 'sp')`` mesh of the conftest's virtual CPU devices (its ring
flash attention through the Pallas kernels in interpret mode): one
momentum-SGD step from zero velocity gives the reference's loss, its
gradient (the velocity) and the updated params. Weights come from its
own init and reach the port's gloo ranks as numpy arrays through
``nos_tpu_torch.bridge`` (``tests/torch_sp_ranks.py``). Each rank runs on
its ``[B/dp, S/sp]`` token block; the loss is the global batch's on
every rank, and a rank's gradient is its share, summed over the mesh.
Rank 0 also runs the one-device port on the whole batch.

Tolerances, f32: the loss to 1e-5, gradients and the velocity (the
gradient after one step from zero) to 1e-4, parameters after the
update to 1e-5 (an update of lr · v shrinks the gradient noise by lr),
the same bars as tests/test_torch_train.py; the ranks' copies of the
loss and params must agree exactly.
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
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.llama import tree_leaves
from nos_tpu_torch.parallel import make_train_step
from tests import torch_sp_ranks as ranks

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5

BASE = dict(n_kv_heads=4)  # GQA: two q heads a kv head


def reference(seed, **overrides):
    """(jax config, jax params, numpy params) of a tiny f32 model."""
    jc = jl.tiny_config(dtype=jnp.float32, **BASE, **overrides)
    jp = jl.init_llama_params(jax.random.key(seed), jc)
    return jc, jp, jax.tree.map(np.asarray, jp)


def leaves_of(tree_np, **overrides):
    """A reference-structured numpy tree as the port's leaf list."""
    cfg = tl.tiny_config(dtype=torch.float32, **BASE, **overrides)
    return [t.numpy() for t in tree_leaves(params_from_numpy(tree_np, cfg, device="cpu"))]


def tokens_np(seed, b=4, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


# (name, config overrides) of the llama_loss cases, each held against the
# one-device port: the ring through the flash kernels' plain versions,
# the plain ring, Ulysses both ways, and a windowed ring
LOSS_CASES = [
    ("ring_flash", dict(attention="flash")),
    ("ring_dense", dict(attention="dense")),
    ("ulysses_flash", dict(attention="flash", sp_strategy="ulysses")),
    ("ulysses_dense", dict(attention="dense", sp_strategy="ulysses")),
    ("ring_flash_window5", dict(attention="flash", sliding_window=5)),
]
ADAMW = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-3, weight_decay=0.1)


def jax_steps(mesh, jc, jp, batches, **kwargs):
    step, shard = jax_make_train_step(mesh, jc, **kwargs)
    state, losses = shard(jp), []
    for tokens in batches:
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state)


def port_steps(params_np, batches, overrides, **kwargs):
    """The one-device port's losses and params after ``batches``."""
    cfg = tl.tiny_config(dtype=torch.float32, **BASE, **overrides)
    step, shard = make_train_step(None, cfg, device="cpu", **kwargs)
    state, losses = shard(params_from_numpy(params_np, cfg, device="cpu")), []
    for tokens in batches:
        state, loss = step(state, torch.from_numpy(tokens))
        losses.append(float(loss))
    return losses, [t.detach().numpy() for t in tree_leaves(state[0])]


def assert_ranks_agree(out, name, n):
    """Every rank holds the same loss and params."""
    first = ranks.load(out, name, 0)
    for r in range(1, n):
        got = ranks.load(out, name, r)
        for key in got:
            np.testing.assert_array_equal(got[key], first[key], err_msg=f"{name} {key} {r}")


def assert_leaves(got, prefix, want, atol, name):
    for i, w in enumerate(want):
        err = float(np.abs(got[f"{prefix}{i}"] - w).max())
        assert err <= atol, (name, prefix, i, err)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)], ids=["dp2_sp2", "sp4"])
def test_loss_and_train_step_match_reference(dims, tmp_path):
    """On one mesh shape:

    - one momentum-SGD step of ``make_train_step`` (ring flash
      attention) against the reference's step on the same mesh shape:
      the loss (``llama_loss``'s value), the velocity (its gradient,
      summed over the mesh) and the params after the update;
    - ``llama_loss`` and its summed gradient for every case of
      LOSS_CASES against the one-device port on the whole batch (itself
      held to the reference in tests/test_torch_train.py);
    - at dp 2 x sp 2, the same SGD step with ``remat`` (each block under
      ``torch.utils.checkpoint``, whose backward replays the block's ring
      shifts, all-to-alls and ring kernels on every rank) against the
      same reference step, and two steps of two accumulated
      micro-batches and two steps of the AdamW factory against the
      one-device port's.
    """
    dp, sp, n = dims[0], dims[1], dims[0] * dims[1]
    flash = dict(attention="flash")
    jc, jp, params_np = reference(3, **flash)
    sgd_batches = [tokens_np(13)]
    want_losses, (want_p, want_v) = jax_steps(
        mesh_from_devices(dims, ("dp", "sp"), jax.devices()[:n]), jc, jp, sgd_batches,
        learning_rate=0.5)
    runs = [("sgd", {**BASE, **flash}, sgd_batches, dict(learning_rate=0.5), None)]
    if dims == (2, 2):
        runs += [("sgd_remat", {**BASE, **flash, "remat": True}, sgd_batches,
                  dict(learning_rate=0.5), None),
                 ("accum", {**BASE, **flash}, [tokens_np(14, b=8)] * 2,
                  dict(learning_rate=0.1, accum_steps=2), None),
                 ("adamw", {**BASE, **flash}, [tokens_np(15)] * 2, {}, ADAMW)]
    tokens = tokens_np(1)
    ranks.spawn(ranks.sp_model, n, tmp_path, tmp_path, dims, params_np, tokens,
                [(name, {**BASE, **o}) for name, o in LOSS_CASES], runs)

    for name in [run[0] for run in runs if run[0].startswith("sgd")]:
        got = ranks.load(tmp_path, name, 0)
        assert_ranks_agree(tmp_path, name, n)
        assert np.abs(got["losses"] - np.array(want_losses)).max() <= LOSS_ATOL, name
        assert_leaves(got, "v", leaves_of(want_v, **flash), GRAD_ATOL, name)
        assert_leaves(got, "p", leaves_of(want_p, **flash), PARAM_ATOL, name)

    for name, _ in LOSS_CASES:
        got = ranks.load(tmp_path, name, 0)
        for r in range(1, n):  # the global loss, bit for bit, on every rank
            assert float(ranks.load(tmp_path, name, r)["loss"]) == float(got["loss"])
        assert abs(float(got["loss"]) - float(got["one_loss"])) <= LOSS_ATOL, name
        for i in range(sum(k.startswith("g") for k in got)):
            err = float(np.abs(got[f"g{i}"] - got[f"one{i}"]).max())
            assert err <= GRAD_ATOL, (name, i, err)

    for name, _, batches, kwargs, adamw in runs:
        if name.startswith("sgd"):
            continue
        assert_ranks_agree(tmp_path, name, n)
        got = ranks.load(tmp_path, name, 0)
        if adamw is not None:
            kwargs = dict(optimizer=functools.partial(torch.optim.AdamW, **adamw))
        losses, params = port_steps(params_np, batches, flash, **kwargs)
        assert np.abs(got["losses"] - np.array(losses)).max() <= LOSS_ATOL, name
        assert_leaves(got, "p", params, PARAM_ATOL, name)
