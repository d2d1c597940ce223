"""Port pipeline parallelism (``parallel/pipeline.py``: the GPipe
schedule over ``pp``, the stacked layout, the head on the last stage)
against the reference's, case for case with
``tests/parallel/test_pipeline.py``.

The reference runs in this process on the conftest's virtual CPU
devices (its shard_map over a ``('pp',)`` mesh of 2 and of 4 and a
``('dp', 'pp')`` 2 x 2 mesh); the port runs on gloo ranks spawned once
per mesh (``tests/torch_ep_pp_ranks.py``), each rank holding its
stage's layers and its rows of the microbatches. Weights come from the
reference's init through ``bridge.params_from_numpy``; its stacked
gradients convert the same way (``layers`` a dict of [L, ...] leaves).

Tolerances, f32: logits within 1e-5 of the reference's pipeline (the
reference's own f32 bar against the sequential stack) and of the
port's sequential ``llama_forward``; the loss within 1e-5 and the whole
stacked gradient within 1e-4 (the bars of tests/test_torch_tp.py), the
same on every rank. MoE layers run at the microbatch's own capacity,
and the pipeline loss carries no aux, as the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu.parallel import pipeline as jpl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.llama import tree_leaves
from nos_tpu_torch.parallel import pipeline as tpl
from tests import torch_ep_pp_ranks as ep_ranks
from tests import torch_sp_ranks as ranks

LOGITS_ATOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4

MESHES = {
    "pp2": ((2,), ("pp",)),
    "pp4": ((4,), ("pp",)),
    "dp2_pp2": ((2, 2), ("dp", "pp")),
}


def tokens_np(seed, b=8, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def params_np(n_layers, **overrides):
    jc = jl.tiny_config(dtype=jnp.float32, n_layers=n_layers, **overrides)
    return jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(0), jc))


# (name, n_layers, config overrides, tokens, n_microbatches, grads) per mesh
CASES = {
    "pp2": [
        ("sequential", 4, {}, tokens_np(1), 0, False),
        ("more_microbatches", 2, {}, tokens_np(1), 8, False),
        ("exact_f32", 2, {}, tokens_np(1, b=4, s=8), 0, False),
        ("loss", 2, {}, tokens_np(1, b=4), 0, True),
        ("loss_remat", 2, dict(remat=True), tokens_np(1, b=4), 0, True),
        ("moe", 2, dict(n_experts=4), tokens_np(1, b=4), 0, True),
    ],
    "pp4": [
        ("sequential", 4, {}, tokens_np(1), 0, False),
        ("loss", 4, {}, tokens_np(1), 0, True),
    ],
    "dp2_pp2": [
        ("sequential", 4, {}, tokens_np(1), 0, False),
        ("loss", 2, {}, tokens_np(1), 0, True),
    ],
}


def reference(mesh, n_layers, overrides, tokens, m, grads):
    """The reference pipeline's logits (and loss and stacked gradient
    leaves in the port's order), and the sequential forward's logits."""
    jc = jl.tiny_config(dtype=jnp.float32, n_layers=n_layers, **overrides)
    p = jax.tree.map(jnp.asarray, params_np(n_layers, **{k: v for k, v in overrides.items()
                                                         if k == "n_experts"}))
    stacked = jpl.stack_layer_params(p)
    toks = jnp.asarray(tokens)
    out = {"logits": np.asarray(jax.jit(
        lambda q, t: jpl.pipeline_llama_forward(q, t, jc, mesh, n_microbatches=m))(
            stacked, toks)),
           "sequential": np.asarray(jl.llama_forward(p, toks, jc))}
    if grads:
        loss, g = jax.jit(jax.value_and_grad(
            lambda q: jpl.pipeline_llama_loss(q, toks, jc, mesh, n_microbatches=m)))(stacked)
        tc = tl.tiny_config(dtype=torch.float32, n_layers=n_layers, **overrides)
        out["loss"] = float(loss)
        out["grads"] = [t.numpy() for t in tree_leaves(params_from_numpy(
            jax.tree.map(np.asarray, g), tc, device="cpu"))]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            dims, names = MESHES[mesh_id]
            n = int(np.prod(dims))
            mesh = mesh_from_devices(dims, names, jax.devices()[:n])
            want = {c[0]: reference(mesh, *c[1:]) for c in CASES[mesh_id]}
            cases = [(name, params_np(layers, **{k: v for k, v in ov.items()
                                                 if k == "n_experts"}),
                      dict(n_layers=layers, **ov), toks, m, grads)
                     for name, layers, ov, toks, m, grads in CASES[mesh_id]]
            out = tmp_path_factory.mktemp(mesh_id)
            ranks.spawn(ep_ranks.pp_mesh, n, out, out, dims, names, cases)
            cache[mesh_id] = dims, names, out, want
        return cache[mesh_id]

    return get


def rank_rows(b, m, dp, d):
    """The global rows rank d of dp holds: microbatches [M, B/M], dim 1
    over dp."""
    m = m or 0
    return np.arange(b).reshape(m, b // m)[:, d * (b // m // dp):(d + 1) * (b // m // dp)] \
        .reshape(-1)


def check_logits(runs, mesh_id, name, keys=("logits", "sequential")):
    dims, names, out, want = runs(mesh_id)
    case = {c[0]: c for c in CASES[mesh_id]}[name]
    tokens, m = case[3], case[4] or dims[names.index("pp")]
    dp = dims[names.index("dp")] if "dp" in names else 1
    for r in range(int(np.prod(dims))):
        d = int(np.unravel_index(r, dims)[names.index("dp")]) if dp > 1 else 0
        rows = rank_rows(tokens.shape[0], m, dp, d)
        got = ranks.load(out, name, r)
        np.testing.assert_array_equal(got["rows"], tokens[rows])
        for key in keys:
            err = float(np.abs(got["logits"] - want[name][key][rows]).max())
            assert err <= LOGITS_ATOL, (mesh_id, name, r, key, err)


def check_loss_and_grads(runs, mesh_id, name):
    dims, names, out, want = runs(mesh_id)
    first = ranks.load(out, name, 0)
    for r in range(int(np.prod(dims))):
        got = ranks.load(out, name, r)
        assert abs(float(got["loss"]) - want[name]["loss"]) <= LOSS_ATOL, (r, got["loss"])
        for i, w in enumerate(want[name]["grads"]):
            np.testing.assert_array_equal(got[f"g{i}"], first[f"g{i}"])
            err = float(np.abs(got[f"g{i}"] - w).max())
            assert err <= GRAD_ATOL, (mesh_id, name, i, err)
    return first


class TestPipelineForward:
    @pytest.mark.parametrize("mesh_id", ["pp2", "pp4"])
    def test_matches_sequential(self, runs, mesh_id):
        check_logits(runs, mesh_id, "sequential")

    def test_more_microbatches_than_stages(self, runs):
        check_logits(runs, "pp2", "more_microbatches")

    def test_composes_with_dp(self, runs):
        check_logits(runs, "dp2_pp2", "sequential")

    def test_exact_in_float32(self, runs):
        check_logits(runs, "pp2", "exact_f32")

    @pytest.mark.parametrize("mesh_id", ["pp2", "pp4", "dp2_pp2"])
    def test_rejects_indivisible_layers_and_batch(self, runs, mesh_id):
        dims, _, out, _ = runs(mesh_id)
        for r in range(int(np.prod(dims))):
            errors = {k: str(v) for k, v in ranks.load(out, "errors", r).items()}
            assert errors["layers"].startswith("ValueError") and "pp stages" in errors["layers"]
            assert errors["batch"].startswith("ValueError") and "microbatches" in errors["batch"]
            assert errors["sp_axis"].startswith("ValueError"), errors["sp_axis"]
            assert errors["llama_forward_pp"].startswith("ValueError")
            assert "pipeline_llama_forward" in errors["llama_forward_pp"]


class TestPipelineTraining:
    def test_loss_and_grads(self, runs):
        got = check_loss_and_grads(runs, "pp4", "loss")
        wq = got["g3"]  # the stacked wq, [L, d, H·hd]: every stage's layers learn
        assert wq.shape[0] == 4
        assert (np.abs(wq).reshape(4, -1).max(axis=1) > 0).all()
        assert int(got["layers_held"]) == 1  # a rank holds its stage's L/pp layers

    def test_stacked_sharding_spec(self):
        class Mesh:
            mesh_dim_names = ("dp", "pp", "tp")
            shape = (2, 2, 2)

        sharding = tpl.pipeline_param_sharding(Mesh(), tl.tiny_config(n_layers=4))
        assert sharding["layers"]["wq"] == ("pp", "dp", "tp")
        assert sharding["layers"]["attn_norm"] == ("pp", None)
        assert sharding["embed"][0] == "tp"
        moe = tpl.pipeline_param_sharding(Mesh(), tl.tiny_config(n_layers=4, n_experts=4))
        assert moe["layers"]["moe"]["w_down"] == ("pp", None, "tp", "dp")

    def test_loss_with_per_tick_remat_matches(self, runs):
        plain = check_loss_and_grads(runs, "pp2", "loss")
        remat = check_loss_and_grads(runs, "pp2", "loss_remat")
        assert abs(float(plain["loss"]) - float(remat["loss"])) <= 1e-6
        np.testing.assert_allclose(plain["g3"], remat["g3"], atol=1e-6)

    def test_loss_composes_with_dp(self, runs):
        check_loss_and_grads(runs, "dp2_pp2", "loss")

    def test_moe_layers_pipeline(self, runs):
        """MoE blocks ride the pipeline at the microbatch's own capacity,
        with no aux in the loss: the reference pipeline's logits, loss and
        gradients (not the sequential forward's, whose capacity is the
        whole batch's)."""
        check_loss_and_grads(runs, "pp2", "moe")
        check_logits(runs, "pp2", "moe", keys=("logits",))


def test_stack_and_bridge_the_stacked_layout():
    """stack_layer_params and the bridge agree on the reference's stacked
    tree, leaf for leaf, dense and MoE."""
    for overrides in ({}, dict(n_experts=4)):
        tree = params_np(3, **overrides)
        jstacked = jax.tree.map(np.asarray, jpl.stack_layer_params(
            jax.tree.map(jnp.asarray, tree)))
        tc = tl.tiny_config(dtype=torch.float32, n_layers=3, **overrides)
        got = tpl.stack_layer_params(params_from_numpy(tree, tc, device="cpu"))
        want = params_from_numpy(jstacked, tc, device="cpu")
        assert list(got) == list(want)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
