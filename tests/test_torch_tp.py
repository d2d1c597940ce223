"""Port tensor parallelism (llama_forward / llama_loss over a mesh with a
``tp`` axis: Megatron-style products, the vocab-parallel embedding,
unembedding and cross entropy, FSDP's gather on use) against the
reference on meshes of the same shapes.

The reference runs in this process on the conftest's virtual CPU
devices: its params placed by its own ``llama_param_sharding`` and its
tokens by ``llama_data_sharding`` over a ``('tp',)`` mesh of 2 and of 4,
``('dp', 'tp')`` 2 x 2 and ``('sp', 'tp')`` 2 x 2 (its ring attention
on the local heads, as ``test_ring_attention.py::test_composes_with_dp_and_tp``),
and XLA inserts the collectives. The port runs on gloo ranks spawned
once per mesh (``tests/torch_tp_ranks.py``), each on its shards
(``sharding.shard_params``) and its token block; weights come from the
reference's init through ``bridge.params_from_numpy``. Cases: dense
attention, the flash kernels (their plain versions here; the reference's
Pallas kernels in interpret mode) and, at sp x tp, Ulysses.

Tolerances, f32, the bars the sp tests hold (tests/test_torch_ring_attention.py,
tests/test_torch_sp_train.py): logits within 2e-5, the loss within
1e-5, the whole gradient (the ranks' shares summed over dp and sp,
gathered over dp and tp) within 1e-4. Every rank of a block holds the
same logits and loss bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.sharding import llama_data_sharding, llama_param_sharding
from tests import torch_sp_ranks as ranks
from tests import torch_tp_ranks as tp_ranks
from tests.test_torch_sp_train import leaves_of, tokens_np

LOGITS_ATOL = 2e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4

BASE = dict(n_kv_heads=4)  # GQA: two q heads a kv head; tp 4 leaves one kv head a rank

MESHES = {
    "tp2": ((2,), ("tp",)),
    "tp4": ((4,), ("tp",)),
    "dp2_tp2": ((2, 2), ("dp", "tp")),
    "sp2_tp2": ((2, 2), ("sp", "tp")),
}
CASES = {
    "dense": dict(attention="dense"),
    "flash": dict(attention="flash"),
    "ulysses_flash": dict(attention="flash", sp_strategy="ulysses"),
}


def cases_for(mesh_id):
    return [name for name in CASES if mesh_id == "sp2_tp2" or not name.startswith("ulysses")]


def reference_case(mesh, overrides, params_np, tokens):
    """(logits, loss, gradient leaves in the port's order) of the
    reference on ``mesh``."""
    jc = jl.tiny_config(dtype=jnp.float32, **BASE, **overrides)
    params = jax.device_put(jax.tree.map(jnp.asarray, params_np), llama_param_sharding(mesh, jc))
    toks = jax.device_put(jnp.asarray(tokens), llama_data_sharding(mesh))
    logits = jax.jit(lambda p, t: jl.llama_forward(p, t, jc, mesh))(params, toks)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.llama_loss(p, t, jc, mesh)))(params, toks)
    return (np.asarray(logits), float(loss),
            leaves_of(jax.tree.map(np.asarray, grads), **overrides))


PAIRS = [(mesh_id, case) for mesh_id in MESHES for case in cases_for(mesh_id)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh id -> the reference's results and the port's ranks' on that
    mesh, computed once (one spawn a mesh) on first use."""
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            dims, names = MESHES[mesh_id]
            n = int(np.prod(dims))
            jc = jl.tiny_config(dtype=jnp.float32, **BASE)
            params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(7), jc))
            tokens = tokens_np(21)
            mesh = mesh_from_devices(dims, names, jax.devices()[:n])
            want = {name: reference_case(mesh, CASES[name], params_np, tokens)
                    for name in cases_for(mesh_id)}
            out = tmp_path_factory.mktemp(mesh_id)
            ranks.spawn(tp_ranks.tp_model, n, out, out, dims, names, params_np, tokens,
                        [(name, {**BASE, **CASES[name]}) for name in cases_for(mesh_id)])
            cache[mesh_id] = dims, names, out, want
        return cache[mesh_id]

    return get


def rank_of(coords, dims):
    """Global rank of mesh coordinates (row-major, as init_device_mesh)."""
    return int(np.ravel_multi_index(coords, dims))


def assembled_logits(out, name, dims, names):
    """The global logits from the blocks of the ranks at tp index 0; every
    tp rank of a block holds the same bytes."""
    lead = [(i, n) for i, n in enumerate(names) if n != "tp"]
    tp_axis = names.index("tp")
    count = dims[lead[0][0]] if lead else 1
    blocks = []
    for j in range(count):
        coords = [0] * len(dims)
        if lead:
            coords[lead[0][0]] = j
        first = ranks.load(out, name, rank_of(coords, dims))["logits"]
        for t in range(1, dims[tp_axis]):
            coords[tp_axis] = t
            np.testing.assert_array_equal(
                ranks.load(out, name, rank_of(coords, dims))["logits"], first)
        blocks.append(first)
    axis = 1 if lead and lead[0][1] == "sp" else 0
    return np.concatenate(blocks, axis=axis)


@pytest.mark.parametrize("mesh_id,case", PAIRS)
def test_logits_match_reference(runs, mesh_id, case):
    dims, names, out, want = runs(mesh_id)
    got = assembled_logits(out, case, dims, names)
    assert got.shape == want[case][0].shape
    err = float(np.abs(got - want[case][0]).max())
    assert err <= LOGITS_ATOL, (mesh_id, case, err)


@pytest.mark.parametrize("mesh_id,case", PAIRS)
def test_loss_matches_reference_on_every_rank(runs, mesh_id, case):
    dims, names, out, want = runs(mesh_id)
    losses = [float(ranks.load(out, case, r)["loss"]) for r in range(int(np.prod(dims)))]
    assert len(set(losses)) == 1, (mesh_id, case, losses)
    assert abs(losses[0] - want[case][1]) <= LOSS_ATOL, (mesh_id, case, losses[0])


@pytest.mark.parametrize("mesh_id,case", PAIRS)
def test_gradients_match_reference(runs, mesh_id, case):
    dims, names, out, want = runs(mesh_id)
    first = ranks.load(out, case, 0)
    for r in range(1, int(np.prod(dims))):
        got = ranks.load(out, case, r)
        for i in range(len(want[case][2])):
            np.testing.assert_array_equal(got[f"g{i}"], first[f"g{i}"])
    for i, w in enumerate(want[case][2]):
        err = float(np.abs(first[f"g{i}"] - w).max())
        assert err <= GRAD_ATOL, (mesh_id, case, i, err)


def test_head_divisibility_and_kv_quant_raise(tmp_path):
    """tp must divide both head counts (ValueError, as the reference's
    kv_cache_sharding; Gemma's one kv head rules tp > 1 out), an Engine
    with kv_quant under a mesh raises ValueError as the reference's does,
    and the quantized rules take 4 or 8 bits only."""
    jc = jl.tiny_config(dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(0), jc))
    ranks.spawn(tp_ranks.tp_contracts, 4, tmp_path, tmp_path, params_np)
    for r in range(4):
        errors = {k: str(v) for k, v in ranks.load(tmp_path, "tp_contracts", r).items()}
        for key in ("cache_kv2_tp4", "forward_kv2_tp4", "train_mqa_tp2", "shard_kv2_tp4",
                    "serve_kv2_tp4", "engine_kv2_tp4"):
            assert errors[key].startswith("ValueError"), (key, errors[key])
            assert "must divide" in errors[key], (key, errors[key])
        assert errors["engine_kv_quant"].startswith("ValueError"), errors
        assert "kv_quant + mesh" in errors["engine_kv_quant"], errors
        assert "bits must be 4 or 8" in errors["bits"], errors
