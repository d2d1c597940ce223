"""Port LoRA training and speculative serving under a mesh against the
reference's.

- ``make_lora_train_step(mesh, ...)`` over ``('dp', 'tp')`` 2 x 2: the
  base sharded by the dense rules (FSDP over dp, Megatron over tp), the
  adapters and their Adam state replicated, targets ``wq`` / ``wv``
  (column-parallel) and ``wo`` / ``w_up`` (row- and column-parallel),
  with B drawn non-zero so every factor's gradient is live from the first
  step. Three Adam steps' losses and adapters against the reference's
  ``make_lora_train_step`` on its own 2 x 2 mesh, on every rank (a tp x
  or 1/tp gradient would drift by the second step).
- ``SpecEngine(mesh=...)``: the target's ``shard_for_serving`` shards
  serve on the rank's tp line (tp 2), the 1-layer draft whole; greedy
  completions token-identical to the reference's ``SpecEngine`` over a
  ``('tp',)`` 2 mesh, on every rank.

The reference runs in this process on the conftest's virtual CPU
devices; the port on four gloo ranks spawned once for the module
(``tests/torch_ep_pp_ranks.py``). Tolerances, f32: losses and adapters
within 1e-5, the one-device LoRA test's bars
(tests/test_torch_lora.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nos_tpu.models import llama as jl
from nos_tpu.models import lora as jlora
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.sharding import llama_data_sharding, llama_param_sharding
from nos_tpu.serve import GenRequest as JRequest, SpecEngine as JSpecEngine
from nos_tpu.serve import shard_for_serving as jax_shard_for_serving
from tests import torch_ep_pp_ranks as ep_ranks
from tests import torch_sp_ranks as ranks

ATOL = 1e-5
TARGETS = ("wq", "wv", "wo", "w_up")
RANK = 4
K = 3


def tokens_np(seed, b=4, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jc = jl.tiny_config(dtype=jnp.float32, n_kv_heads=4)
    jp = jl.init_llama_params(jax.random.key(40), jc)
    params_np = jax.tree.map(np.asarray, jp)
    lora = jlora.LoraConfig(rank=RANK, targets=TARGETS)
    adapters = jlora.init_lora_params(jax.random.key(41), jc, lora)
    rng = np.random.default_rng(42)
    adapters_np = {"layers": [
        {t: {"a": np.asarray(ab["a"]),
             "b": (0.1 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
         for t, ab in layer.items()} for layer in adapters["layers"]]}
    batches = [tokens_np(43)] * 3  # one batch, three steps: the loss falls

    mesh = mesh_from_devices((2, 2), ("dp", "tp"), jax.devices()[:4])
    step, shard = jlora.make_lora_train_step(mesh, jc, lora, learning_rate=1e-2)
    state = shard(jax.tree.map(jnp.asarray, adapters_np))
    base = jax.device_put(jp, llama_param_sharding(mesh, jc))
    want = {"losses": [], "adapters": []}
    for tokens in batches:
        state, loss = step(state, base, jax.device_put(jnp.asarray(tokens),
                                                       llama_data_sharding(mesh)))
        want["losses"].append(float(loss))
        want["adapters"].append(jax.tree.map(np.asarray, state[0]))

    jdc = jl.tiny_config(dtype=jnp.float32, n_kv_heads=4, n_layers=1)
    draft_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(44), jdc))
    rng = np.random.default_rng(45)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 12, 9)]
    budgets = (7, 5, 9)
    tp2 = mesh_from_devices((2,), ("tp",), jax.devices()[:2])
    eng = JSpecEngine(jax_shard_for_serving(jp, tp2, jc), jc,
                      jax.tree.map(jnp.asarray, draft_np), jdc, k=K, max_slots=2,
                      max_len=64, mesh=tp2)
    ids = [eng.submit(JRequest(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, budgets)]
    got = eng.run()
    want["spec"] = [got[i] for i in ids]

    out = tmp_path_factory.mktemp("lora_spec")
    ranks.spawn(ep_ranks.lora_spec_mesh, 4, out, out, params_np, adapters_np, RANK, batches,
                draft_np, prompts, budgets, K)
    return out, want


def test_lora_three_adam_steps_match_reference_on_dp_tp(runs):
    out, want = runs
    for r in range(4):
        got = ranks.load(out, "lora_spec", r)
        losses = [float(got[f"loss{n}"]) for n in range(3)]
        np.testing.assert_allclose(losses, want["losses"], atol=ATOL)
        for n, tree in enumerate(want["adapters"]):
            for i, layer in enumerate(tree["layers"]):
                for t, ab in layer.items():
                    for key, w in ab.items():
                        err = float(np.abs(got[f"s{n}_{i}_{t}_{key}"] - w).max())
                        assert err <= ATOL, (r, n, i, t, key, err)
    assert losses[2] < losses[0]


def test_spec_engine_under_tp_is_token_identical(runs):
    out, want = runs
    for r in range(4):
        got = ranks.load(out, "lora_spec", r)
        rows = [[t for t in row if t >= 0] for row in got["spec"].tolist()]
        assert rows == want["spec"], r
        assert int(got["rounds"]) > 0
