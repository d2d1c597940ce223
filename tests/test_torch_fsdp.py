"""Port FSDP and tensor-parallel training (make_train_step over a
``('dp', 'tp')`` 2 x 2 mesh) against the reference's make_train_step on
a mesh of the same shape, as ``tests/parallel/test_fsdp.py`` runs it.

The reference runs in this process on the conftest's virtual CPU
devices (its flash attention through the Pallas kernels in interpret
mode); the port on four gloo ranks spawned once for every run
(``tests/torch_tp_ranks.py``), each holding its shards of the params and
of the optimizer state: FSDP over dp and Megatron-style tp, the 2-D
weights gathered on use and their gradients reduce-scattered. Weights
come from the reference's init through ``bridge.params_from_numpy``.
Two steps of the built-in momentum SGD and of AdamW (the reference's
``optax.adamw``, the port's ``torch.optim.AdamW`` factory), with and
without remat.

Tolerances, f32, the sp tests' bars (tests/test_torch_sp_train.py): the
losses within 1e-5, the velocity within 1e-4, the params within 1e-5;
every rank gathers the same state bit for bit. The memory contract is
the reference's: a rank's param bytes at most the global bytes over
dp·tp plus the replicated (1-D) bytes, its optimizer state the bytes of
its params (SGD's velocity) or twice them (AdamW's two moments).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from tests import torch_sp_ranks as ranks
from tests import torch_tp_ranks as tp_ranks
from tests.test_torch_sp_train import assert_leaves, assert_ranks_agree, leaves_of, tokens_np

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5

DIMS, NAMES = (2, 2), ("dp", "tp")
BASE = dict(n_kv_heads=4, attention="flash")
# eps well above the gradients' summation noise (tests/test_torch_train.py)
ADAMW = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-3, weight_decay=0.1)
OPTAX = dict(learning_rate=1e-2, b1=0.8, b2=0.95, eps=1e-3, weight_decay=0.1)
RUNS = {
    "sgd": (dict(), dict(learning_rate=0.5), None),
    "sgd_remat": (dict(remat=True), dict(learning_rate=0.5), None),
    "adamw": (dict(), {}, ADAMW),
    "adamw_remat": (dict(remat=True), {}, ADAMW),
}


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """The reference's runs and the port's, on the 2 x 2 mesh."""
    jc = jl.tiny_config(dtype=jnp.float32, **BASE)
    jp = jl.init_llama_params(jax.random.key(11), jc)
    params_np = jax.tree.map(np.asarray, jp)
    batches = [tokens_np(31), tokens_np(32)]
    mesh = mesh_from_devices(DIMS, NAMES, jax.devices()[:4])
    want = {}
    for name, (overrides, kwargs, adamw) in RUNS.items():
        cfg = jl.tiny_config(dtype=jnp.float32, **BASE, **overrides)
        jax_kwargs = dict(kwargs) if adamw is None else dict(optimizer=optax.adamw(**OPTAX))
        step, shard = jax_make_train_step(mesh, cfg, **jax_kwargs)
        state, losses = shard(jl.init_llama_params(jax.random.key(11), cfg)), []
        for tokens in batches:
            state, loss = step(state, jnp.asarray(tokens))
            losses.append(float(loss))
        velocity = None
        if adamw is None:
            velocity = leaves_of(jax.tree.map(np.asarray, state[1]))
        want[name] = losses, leaves_of(jax.tree.map(np.asarray, state[0])), velocity
    out = tmp_path_factory.mktemp("fsdp")
    runs = [(name, {**BASE, **o}, batches, kwargs, adamw)
            for name, (o, kwargs, adamw) in RUNS.items()]
    ranks.spawn(tp_ranks.fsdp_train, 4, out, out, DIMS, NAMES, params_np, runs)
    whole_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jp))
    return out, want, whole_bytes


@pytest.mark.parametrize("name", list(RUNS))
def test_steps_match_reference(fsdp, name):
    out, want, _ = fsdp
    losses, params, velocity = want[name]
    assert_ranks_agree(out, name, 4)
    got = ranks.load(out, name, 0)
    assert np.abs(got["losses"] - np.array(losses)).max() <= LOSS_ATOL, name
    if velocity is not None:
        assert_leaves(got, "v", velocity, GRAD_ATOL, name)
    assert_leaves(got, "p", params, PARAM_ATOL, name)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_state_bytes_shard_over_the_mesh(fsdp, name):
    out, _, whole_bytes = fsdp
    for r in range(4):
        got = {k: int(v) for k, v in ranks.load(out, name, r).items()
               if k.endswith("_bytes")}
        assert got["param_bytes"] <= whole_bytes / 4 + got["replicated_bytes"], (r, got)
        moments = 1 if name == "sgd" else 2
        assert got["opt_bytes"] == moments * got["param_bytes"], (r, got)


def test_optimizer_state_sharding(tmp_path):
    """The velocity tree takes the params' rules wholesale; AdamW's
    moments take their param's spec and its step count replication; a
    state with no param-shaped part raises ValueError, as the
    reference's does."""
    jc = jl.tiny_config(dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(0), jc))
    ranks.spawn(tp_ranks.optimizer_rules, 4, tmp_path, tmp_path, params_np)
    for r in range(4):
        got = ranks.load(tmp_path, "optimizer_rules", r)
        assert bool(got["velocity_same"])
        assert int(got["n_entries"]) == int(got["n_leaves"])
        assert got["adam_moments"].all() and got["adam_steps"].all()
        assert str(got["other"]).startswith("ValueError")
        assert "no params-structured" in str(got["other"])
