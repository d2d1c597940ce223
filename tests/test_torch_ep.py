"""Port expert parallelism (``moe_mlp`` and MoE models over meshes with an
``ep`` axis: the global capacity race over dp and sp, the rank's
experts, their outputs gathered over ep) against the reference on meshes
of the same shapes.

The reference runs in this process on the conftest's virtual CPU
devices: its params placed by its own ``llama_param_sharding`` (experts
by ``moe_param_sharding``) and its tokens by ``llama_data_sharding``
over ``('ep',)`` 4, ``('dp', 'ep')`` 2 x 2, ``('sp', 'ep')`` 2 x 2 and
``('tp', 'ep')`` 2 x 2, and XLA inserts the collectives; its routing is
global, so its ``moe_mlp`` on the whole batch is the reference for every
mesh. The port runs on gloo ranks spawned once per mesh
(``tests/torch_ep_pp_ranks.py``), each on its shards and its token
block. Weights come from the reference's init through
``bridge.params_from_numpy``. Every case runs at capacity factor 8
(nothing dropped) and 1.0 (capacity binds), with a token mask on the
MoE layer alone.

Tolerances, f32: the kept-pair mask exactly the reference's (computed
here from the reference's routing of the global batch); ``moe_mlp``'s
output and aux within 1e-5 (tp sums its partials in another order);
logits within 2e-5, the loss and aux within 1e-5 and the whole gradient
within 1e-4, the bars of tests/test_torch_tp.py. Every rank holding a
block holds the same values. The dp x ep trainer's losses within 1e-5
and params within 1e-5 of the reference's ``make_train_step`` on its
``('dp', 'ep')`` mesh; a dp x ep checkpoint restored onto one device bit
for bit. Serving (generate() on a
left-padded batch, an Engine whose rows finish and ride, dense and int8
stacks) over ``('ep',)`` 2, ``('tp',)`` 2 and ``('tp', 'ep')`` 2 x 2
is token-identical to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.models import moe as jm
from nos_tpu.models import quantize as jq
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.sharding import llama_data_sharding, llama_param_sharding
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.llama import tree_leaves
from tests import torch_ep_pp_ranks as ep_ranks
from tests import torch_sp_ranks as ranks

MOE_ATOL = 1e-5
LOGITS_ATOL = 2e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5

MESHES = {
    "ep4": ((4,), ("ep",)),
    "dp2_ep2": ((2, 2), ("dp", "ep")),
    "sp2_ep2": ((2, 2), ("sp", "ep")),
    "tp2_ep2": ((2, 2), ("tp", "ep")),
}
FACTORS = (8.0, 1.0)
PAIRS = [(m, f) for m in MESHES for f in FACTORS]
BASE = dict(n_kv_heads=4, n_experts=4)


def tokens_np(seed, b=4, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def moe_inputs():
    jc = jm.MoeConfig(d_model=16, d_ff=32, n_experts=4, top_k=2, dtype=jnp.float32)
    params = {k: np.asarray(v) for k, v in jm.init_moe_params(jax.random.key(3), jc).items()}
    rng = np.random.default_rng(8)  # at factor 1.0: 6 unmasked pairs dropped
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    mask = rng.random((4, 8)) < 0.9
    return params, x, mask


def reference_keep(params, x, mask, config):
    """The kept-pair mask [B, S, k] of the reference's routing of the
    global batch: its own lines (f32 router, top_k, the masked cumsum
    race against the capacity of B·S tokens)."""
    c = config
    b, s, d = x.shape
    t = b * s
    flat = jnp.asarray(x).reshape(t, d)
    probs = jax.nn.softmax(flat.astype(jnp.float32) @ jnp.asarray(params["router"]), axis=-1)
    _, top_e = jax.lax.top_k(probs, c.top_k)
    onehot = jax.nn.one_hot(top_e.reshape(t * c.top_k), c.n_experts, dtype=jnp.int32)
    pair_mask = jnp.repeat(jnp.asarray(mask).reshape(t), c.top_k)
    onehot = onehot * pair_mask[:, None].astype(onehot.dtype)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = (pos < jm.capacity_per_expert(t, c)) & pair_mask
    return np.asarray(keep).reshape(b, s, c.top_k)


def port_leaves(tree_np, **overrides):
    cfg = tl.tiny_config(dtype=torch.float32, **overrides)
    return [t.numpy() for t in tree_leaves(params_from_numpy(tree_np, cfg, device="cpu"))]


def reference_case(mesh, factor, params_np, tokens):
    """(logits, aux, loss, gradient leaves in the port's order) of the
    reference on ``mesh``."""
    jc = jl.tiny_config(dtype=jnp.float32, moe_capacity_factor=factor, **BASE)
    params = jax.device_put(jax.tree.map(jnp.asarray, params_np),
                            llama_param_sharding(mesh, jc))
    toks = jax.device_put(jnp.asarray(tokens), llama_data_sharding(mesh))
    logits, aux = jax.jit(lambda p, t: jl.llama_forward(p, t, jc, mesh, with_aux=True))(
        params, toks)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.llama_loss(p, t, jc, mesh)))(params, toks)
    return (np.asarray(logits), float(aux), float(loss),
            port_leaves(jax.tree.map(np.asarray, grads), moe_capacity_factor=factor, **BASE))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh id -> (dims, names, output dir, the reference's results), one
    spawn a mesh, on first use."""
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            dims, names = MESHES[mesh_id]
            n = int(np.prod(dims))
            jc = jl.tiny_config(dtype=jnp.float32, **BASE)
            params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(9), jc))
            tokens = tokens_np(22)
            moe_np, x, mask = moe_inputs()
            mesh = mesh_from_devices(dims, names, jax.devices()[:n])
            want = {}
            for f in FACTORS:
                mc = jm.MoeConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                                  capacity_factor=f, dtype=jnp.float32)
                out, aux = jm.moe_mlp(jax.tree.map(jnp.asarray, moe_np), jnp.asarray(x), mc,
                                      return_aux=True, token_mask=jnp.asarray(mask))
                want[f] = dict(moe=np.asarray(out), aux=float(aux),
                               keep=reference_keep(moe_np, x, mask, mc),
                               model=reference_case(mesh, f, params_np, tokens))
            out = tmp_path_factory.mktemp(mesh_id)
            ranks.spawn(ep_ranks.ep_mesh, n, out, out, dims, names, moe_np, x, mask,
                        params_np, tokens, FACTORS)
            cache[mesh_id] = dims, names, out, want
        return cache[mesh_id]

    return get


def assembled(out, name, key, dims, names, trailing=0):
    """The global array from every rank's block of ``key`` ([B/dp, S/sp,
    ...] at (dp, sp) index), checking that every rank of a block holds
    the same bytes. ``trailing``: a flat pair axis to fold first."""
    blocks = {}
    for r in range(int(np.prod(dims))):
        coords = dict(zip(names, np.unravel_index(r, dims)))
        at = (coords.get("dp", 0), coords.get("sp", 0))
        got = ranks.load(out, name, r)[key]
        if at in blocks:
            np.testing.assert_array_equal(got, blocks[at])
        else:
            blocks[at] = got
    dp = dims[names.index("dp")] if "dp" in names else 1
    sp = dims[names.index("sp")] if "sp" in names else 1
    return np.concatenate([np.concatenate([blocks[(d, s)] for s in range(sp)], axis=1)
                           for d in range(dp)], axis=0)


def same_on_every_rank(out, name, key, dims):
    values = [ranks.load(out, name, r)[key] for r in range(int(np.prod(dims)))]
    for v in values[1:]:
        np.testing.assert_array_equal(v, values[0])
    return values[0]


def pair_blocks(out, name, dims, names, b, s, k=2):
    """The kept-pair masks of the ranks reshaped to their [B/dp, S/sp, k]
    blocks, assembled."""
    blocks = {}
    dp = dims[names.index("dp")] if "dp" in names else 1
    sp = dims[names.index("sp")] if "sp" in names else 1
    for r in range(int(np.prod(dims))):
        coords = dict(zip(names, np.unravel_index(r, dims)))
        at = (coords.get("dp", 0), coords.get("sp", 0))
        got = ranks.load(out, name, r)["keep"].reshape(b // dp, s // sp, k)
        if at in blocks:
            np.testing.assert_array_equal(got, blocks[at])
        blocks[at] = got
    return np.concatenate([np.concatenate([blocks[(d, q)] for q in range(sp)], axis=1)
                           for d in range(dp)], axis=0)


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_kept_pairs_are_the_references(runs, mesh_id, factor):
    dims, names, out, want = runs(mesh_id)
    keep = want[factor]["keep"]
    got = pair_blocks(out, f"f{factor}", dims, names, *keep.shape[:2])
    np.testing.assert_array_equal(got, keep)
    if factor == 1.0:  # capacity binds: some unmasked pairs are dropped
        _, _, mask = moe_inputs()
        assert (~keep & mask[..., None]).any()


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_moe_mlp_matches_reference(runs, mesh_id, factor):
    dims, names, out, want = runs(mesh_id)
    got = assembled(out, f"f{factor}", "moe", dims, names)
    err = float(np.abs(got - want[factor]["moe"]).max())
    assert err <= MOE_ATOL, (mesh_id, factor, err)


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_aux_is_the_global_batch_s(runs, mesh_id, factor):
    """The Switch aux over dp x sp: the global top-1 fractions and mean
    probabilities, the same value on every rank."""
    dims, names, out, want = runs(mesh_id)
    aux = float(same_on_every_rank(out, f"f{factor}", "aux", dims))
    assert abs(aux - want[factor]["aux"]) <= MOE_ATOL, (mesh_id, aux, want[factor]["aux"])
    model_aux = float(same_on_every_rank(out, f"f{factor}", "model_aux", dims))
    assert abs(model_aux - want[factor]["model"][1]) <= LOSS_ATOL


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_logits_match_reference(runs, mesh_id, factor):
    dims, names, out, want = runs(mesh_id)
    got = assembled(out, f"f{factor}", "logits", dims, names)
    err = float(np.abs(got - want[factor]["model"][0]).max())
    assert err <= LOGITS_ATOL, (mesh_id, factor, err)


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_loss_matches_reference_on_every_rank(runs, mesh_id, factor):
    dims, names, out, want = runs(mesh_id)
    loss = float(same_on_every_rank(out, f"f{factor}", "loss", dims))
    assert abs(loss - want[factor]["model"][2]) <= LOSS_ATOL, (mesh_id, factor, loss)


@pytest.mark.parametrize("mesh_id,factor", PAIRS)
def test_gradients_match_reference(runs, mesh_id, factor):
    dims, names, out, want = runs(mesh_id)
    grads = want[factor]["model"][3]
    for i, w in enumerate(grads):
        got = same_on_every_rank(out, f"f{factor}", f"g{i}", dims)
        err = float(np.abs(got - w).max())
        assert err <= GRAD_ATOL, (mesh_id, factor, i, err)
    assert float(np.abs(grads[6]).max()) > 0  # layer 0's router learns


# ------------------------------------------------------ training and checkpoint


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two momentum-SGD steps over ('dp', 'ep') 2 x 2 on both sides (the
    reference's test_dp_ep_mesh_step / test_ep_loss_matches_single_device
    setup at capacity factor 2), then the port's state saved."""
    overrides = dict(moe_capacity_factor=2.0, **BASE)
    jc = jl.tiny_config(dtype=jnp.float32, **overrides)
    params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(0), jc))
    batches = [tokens_np(4), tokens_np(5)]
    mesh = mesh_from_devices((2, 2), ("dp", "ep"), jax.devices()[:4])
    step, shard_state = jax_make_train_step(mesh, jc, learning_rate=0.1)
    state = shard_state(jax.tree.map(jnp.asarray, params_np))
    losses = []
    for tokens in batches:
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    want = [port_leaves(jax.tree.map(np.asarray, tree), **overrides) for tree in state]
    out = tmp_path_factory.mktemp("ep_train")
    ranks.spawn(ep_ranks.ep_train, 4, out, out, (2, 2), ("dp", "ep"), params_np, overrides,
                batches, str(out / "ckpt"))
    return out, losses, want[0] + want[1]


def test_dp_ep_train_steps_match_reference(trained):
    out, losses, want = trained
    for r in range(4):
        got = ranks.load(out, "train", r)
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
        # a rank holds E/ep experts, d_model over dp; the router whole
        assert list(got["stack_shape"]) == [2, 32, 128]
        assert list(got["router_shape"]) == [64, 4]
        for i, w in enumerate(want):
            err = float(np.abs(got[f"w{i}"] - w).max())
            assert err <= PARAM_ATOL, (r, i, err)


def test_dp_ep_checkpoint_restores_onto_one_device_bit_for_bit(trained):
    out, _, _ = trained
    got = ranks.load(out, "train", 0)
    assert int(got["restored_step"]) == 3
    assert bool(got["bit_identical"])


# ------------------------------------------------------------------ serving


def serving_setup():
    overrides = dict(moe_capacity_factor=1.25, **BASE)
    jc = jl.tiny_config(dtype=jnp.float32, **overrides)
    params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(13), jc))
    prompt = tokens_np(14, b=3, s=8)
    prompt[0, :3] = -1
    prompt[2, :6] = -1
    rng = np.random.default_rng(15)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 30, 11)]
    return jc, params_np, overrides, prompt, prompts, (6, 4, 7)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jc, params_np, overrides, prompt, prompts, budgets = serving_setup()
    jp = jax.tree.map(jnp.asarray, params_np)
    want = {"generate": np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 6, pad_id=-1))}
    for fmt, tree in (("f32", jp), ("int8", jq.quantize_params(jp))):
        eng = JEngine(tree, jc, max_slots=2, max_len=64, ticks_per_sync=4, prefill_chunk=16)
        ids = [eng.submit(JRequest(prompt=p, max_new_tokens=n))
               for p, n in zip(prompts, budgets)]
        got = eng.run()
        want[f"engine_{fmt}"] = [got[i] for i in ids]
    out = tmp_path_factory.mktemp("ep_serve")
    ranks.spawn(ep_ranks.ep_serve, 4, out, out, params_np, overrides, prompt, -1, prompts,
                budgets, list(SERVE_MESHES.items()))
    return out, want


# a replica serves on the mesh's ('tp', 'ep') plane, replicated over dp
SERVE_MESHES = {"ep2": ("dp", "ep"), "tp2": ("dp", "tp"), "tp2_ep2": ("tp", "ep")}
# the rank's w_gate stack [E/ep, d, d_ff/tp] on each
STACK_SHAPES = {"ep2": [2, 64, 128], "tp2": [4, 64, 64], "tp2_ep2": [2, 64, 64]}


@pytest.mark.parametrize("mesh_id", list(SERVE_MESHES))
def test_generate_left_padded_is_token_identical(served, mesh_id):
    out, want = served
    for r in range(4):
        np.testing.assert_array_equal(ranks.load(out, mesh_id, r)["generate"],
                                      want["generate"])


@pytest.mark.parametrize("mesh_id", list(SERVE_MESHES))
@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_engine_is_token_identical(served, mesh_id, fmt):
    """Two slots for three requests of unequal budgets, one admitted in
    16-token pieces: finished and idle rows ride the batch out of the
    global capacity race; the rank holds E/ep experts and d_ff/tp of
    each."""
    out, want = served
    for r in range(4):
        got = ranks.load(out, mesh_id, r)
        rows = [[t for t in row if t >= 0] for row in got[f"engine_{fmt}"].tolist()]
        assert rows == want[f"engine_{fmt}"], (mesh_id, fmt, r)
        assert list(got[f"stack_shape_{fmt}"]) == STACK_SHAPES[mesh_id]
