"""Port tensor-parallel serving (serve/sharded.py, Engine(mesh=...) with
a head-sharded KV cache) against the reference's tp Engine, on meshes of
the shapes ``tests/models/test_sharded_serving.py`` serves on.

The reference runs in this process on the conftest's virtual CPU
devices: ``shard_for_serving`` places its f32, int8 and int4 (group 16)
trees on a ``('tp',)`` mesh of 2 and of 4 and on a ``('dp', 'tp')`` 2 x 2
mesh, and its Engine serves four requests (budgets 5-8) from that
placement. The port runs the same workload on gloo ranks spawned once
per mesh (``tests/torch_tp_ranks.py``): every rank holds its
``shard_for_serving`` shards and its ``n_kv_heads/tp`` heads of the
cache and runs the same host loop. Weights come from the reference's
init through ``bridge.params_from_numpy``; each side quantizes them
itself (bit-identical quantizers, tests/test_torch_quantize.py).

Greedy tokens must be identical to the reference's, on every rank. A
rank's cache holds its heads only (bytes the whole cache's over tp) and
its weights the 2-D bytes over tp plus the replicated norms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nos_tpu.models import llama as jl
from nos_tpu.models import quantize as jq
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.serve import Engine as JaxEngine
from nos_tpu.serve import GenRequest as JaxRequest
from nos_tpu.serve import shard_for_serving as jax_shard_for_serving
from tests import torch_sp_ranks as ranks
from tests import torch_tp_ranks as tp_ranks

MESHES = {
    "tp2": ((2,), ("tp",)),
    "tp4": ((4,), ("tp",)),
    "dp2_tp2": ((2, 2), ("dp", "tp")),
}
FORMATS = {"f32": None, "int8": None, "int4": 16}  # int4: its group


def prompts(n=4):
    rng = np.random.default_rng(100)
    return [rng.integers(1, 256, 4 + 3 * i).tolist() for i in range(n)]


def reference_tokens(mesh, config, tree, fmt):
    if fmt == "int8":
        tree = jq.quantize_params(tree)
    elif fmt == "int4":
        tree = jq.quantize_params_int4(tree, group=FORMATS[fmt])
    eng = JaxEngine(jax_shard_for_serving(tree, mesh, config), config, max_slots=2,
                    max_len=64, ticks_per_sync=4, mesh=mesh)
    ids = [eng.submit(JaxRequest(prompt=p, max_new_tokens=5 + i))
           for i, p in enumerate(prompts())]
    got = eng.run()
    return [got[i] for i in ids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh id -> (the reference's completions by format, the port's
    output directory), computed once a mesh on first use."""
    cache = {}
    config = jl.tiny_config(dtype=jnp.float32)
    params = jl.init_llama_params(jax.random.key(0), config)
    params_np = jax.tree.map(np.asarray, params)

    def get(mesh_id):
        if mesh_id not in cache:
            dims, names = MESHES[mesh_id]
            n = int(np.prod(dims))
            mesh = mesh_from_devices(dims, names, jax.devices()[:n])
            want = {fmt: reference_tokens(mesh, config, params, fmt) for fmt in FORMATS}
            out = tmp_path_factory.mktemp(mesh_id)
            ranks.spawn(tp_ranks.tp_serve, n, out, out, dims, names, params_np, prompts(),
                        [(fmt, fmt, FORMATS[fmt]) for fmt in FORMATS])
            cache[mesh_id] = n, dims, names, out, want
        return cache[mesh_id]

    return get


def completions(got) -> list:
    return [[int(t) for t in row if t >= 0] for row in got["tokens"]]


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_tp_engine_token_identical_to_reference(runs, mesh_id, fmt):
    n, _, _, out, want = runs(mesh_id)
    for r in range(n):
        assert completions(ranks.load(out, fmt, r)) == want[fmt], (mesh_id, fmt, r)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_cache_and_weights_shard_over_tp(runs, mesh_id):
    n, dims, names, out, _ = runs(mesh_id)
    tp = dims[names.index("tp")]
    config = jl.tiny_config()
    whole_cache = 2 * config.n_layers * 2 * 64 * config.n_kv_heads * config.head_dim * 4
    params = jl.init_llama_params(jax.random.key(0), jl.tiny_config(dtype=jnp.float32))
    leaves = jax.tree.leaves(params)
    two_d = sum(x.size * 4 for x in leaves if x.ndim == 2)
    one_d = sum(x.size * 4 for x in leaves if x.ndim == 1)
    for r in range(n):
        got = ranks.load(out, "f32", r)
        assert int(got["cache_heads"]) == config.n_kv_heads // tp
        assert int(got["cache_bytes"]) == whole_cache // tp
        assert int(got["weight_bytes"]) == two_d // tp + one_d
