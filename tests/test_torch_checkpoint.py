"""Port checkpoint / resume (parallel/checkpoint.py, torch.distributed.checkpoint)
against the reference's contracts (``tests/parallel/test_checkpoint.py``)
and its training state.

A state trained one step by ``make_train_step`` on a ``('dp', 'tp')``
2 x 2 mesh of gloo ranks (``tests/torch_tp_ranks.py``), built-in SGD and
the AdamW factory, is saved as DTensor shards and restored: onto the
same mesh, onto a ``('tp',)`` mesh of 4 (another layout of every 2-D
leaf) and onto one device. The gathered leaves must be bit-identical to
those saved, and the state saved is held to the reference's
make_train_step step on a mesh of the same shape (the sp tests' bars:
params 1e-5, velocity 1e-4). Training continues from the tp-4 restore:
its next step agrees with the 2 x 2 mesh's next step within the same
bars. Then the async ``Checkpointer`` loop (three saves, two kept, the
latest restored bit for bit, a stale step raising), the stale step of
``save_checkpoint`` and its ``force``, and the missing path, which
raises ``FileNotFoundError`` and creates nothing.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.parallel import checkpoint as ck
from nos_tpu_torch.parallel import make_train_step
from tests import torch_sp_ranks as ranks
from tests import torch_tp_ranks as tp_ranks
from tests.test_torch_fsdp import ADAMW, OPTAX
from tests.test_torch_sp_train import tokens_np

GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-5


def port_leaves(tree_np) -> list:
    """A reference-structured numpy tree as the port's leaf list."""
    cfg = tl.tiny_config(dtype=torch.float32)
    return [t.numpy() for t in tl.tree_leaves(params_from_numpy(tree_np, cfg, device="cpu"))]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """kind -> (the ranks' results, the reference's state after one step
    as port-ordered leaves: params, then the velocity for SGD)."""
    jc = jl.tiny_config(dtype=jnp.float32)
    jp = jl.init_llama_params(jax.random.key(3), jc)
    params_np = jax.tree.map(np.asarray, jp)
    batches = [tokens_np(41), tokens_np(42)]
    mesh = mesh_from_devices((2, 2), ("dp", "tp"), jax.devices()[:4])
    out = {}
    for kind, adamw in (("sgd", None), ("adamw", ADAMW)):
        kwargs = {} if adamw is None else dict(optimizer=optax.adamw(**OPTAX))
        step, shard = jax_make_train_step(mesh, jc, **kwargs)
        state, _ = step(shard(jp), jnp.asarray(batches[0]))
        want = port_leaves(jax.tree.map(np.asarray, state[0]))
        if adamw is None:
            want += port_leaves(jax.tree.map(np.asarray, state[1]))
        where = tmp_path_factory.mktemp(kind)
        ranks.spawn(tp_ranks.checkpoint_cases, 4, where, where, params_np, batches, adamw)
        out[kind] = [ranks.load(where, f"ckpt_{kind}", r) for r in range(4)], want, where
    return out


KINDS = ["sgd", "adamw"]


def n_saved(got) -> int:
    return sum(1 for k in got if k.startswith("saved"))


@pytest.mark.parametrize("kind", KINDS)
def test_saved_state_matches_reference_step(saved, kind):
    got, want, _ = saved[kind]
    n_params = len(want) // 2 if kind == "sgd" else len(want)
    for i, w in enumerate(want):
        atol = PARAM_ATOL if i < n_params else GRAD_ATOL
        err = float(np.abs(got[0][f"saved{i}"] - w).max())
        assert err <= atol, (kind, i, err)


@pytest.mark.parametrize("target", ["same", "onto"])
@pytest.mark.parametrize("kind", KINDS)
def test_restore_is_bit_identical(saved, kind, target):
    """Onto the same 2 x 2 mesh and onto tp 4, on every rank."""
    got, _, _ = saved[kind]
    for r in range(4):
        assert list(got[r]["steps"]) == [5, 5]
        assert int(got[r]["latest"]) == 5
        for i in range(n_saved(got[r])):
            np.testing.assert_array_equal(got[r][f"{target}{i}"], got[r][f"saved{i}"])
    if kind == "adamw":
        assert (got[0]["adam_steps"] == 1.0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_restore_onto_one_device_is_bit_identical(saved, kind):
    got, _, _ = saved[kind]
    assert int(got[0]["one_step"]) == 5
    for i in range(n_saved(got[0])):
        np.testing.assert_array_equal(got[0][f"one{i}"], got[0][f"saved{i}"])


@pytest.mark.parametrize("kind", KINDS)
def test_training_continues_on_the_new_mesh(saved, kind):
    got, want, _ = saved[kind]
    assert np.isfinite(float(got[0]["continued_loss"]))
    n_params = len(want) // 2 if kind == "sgd" else len(want)
    for i in range(n_saved(got[0])):
        atol = PARAM_ATOL if i < n_params else GRAD_ATOL
        err = float(np.abs(got[0][f"cont_b{i}"] - got[0][f"cont_a{i}"]).max())
        assert err <= atol, (kind, i, err)


@pytest.mark.parametrize("kind", KINDS)
def test_async_loop_keeps_the_latest_and_refuses_stale_steps(saved, kind):
    got, _, where = saved[kind]
    for r in range(4):
        assert int(got[r]["loop_latest"]) == 2 and int(got[r]["loop_restored_step"]) == 2
        assert list(got[r]["loop_kept"]) == ["1", "2"]
        assert bool(got[r]["loop_exact"])
        assert str(got[r]["stale"]).startswith("RuntimeError"), got[r]["stale"]
        assert str(got[r]["stale_sync"]).startswith("RuntimeError"), got[r]["stale_sync"]
        assert "latest is 5" in str(got[r]["stale_sync"])
        assert bool(got[r]["forced_exact"])
    assert sorted(os.listdir(where / f"ckpt_{kind}")) == ["5"]


def test_missing_checkpoint_raises_and_creates_nothing(tmp_path):
    cfg = tl.tiny_config(dtype=torch.float32)
    _, shard = make_train_step(None, cfg, device="cpu")
    state = shard(tl.init_llama_params(cfg, 0, device="cpu"))
    assert ck.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "empty"), state)
    assert not (tmp_path / "empty").exists()
    os.makedirs(tmp_path / "bare")
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "bare"), state)


def test_one_device_round_trip(tmp_path):
    """mesh=None: whole tensors, no process group; a stale step raises."""
    cfg = tl.tiny_config(dtype=torch.bfloat16)
    step, shard = make_train_step(None, cfg, device="cpu", learning_rate=1.0)
    state, _ = step(shard(tl.init_llama_params(cfg, 0, device="cpu")),
                    torch.from_numpy(tokens_np(5)))
    ck.save_checkpoint(str(tmp_path / "c"), state, 3)
    target = shard(tl.init_llama_params(cfg, 1, device="cpu"))
    restored, got_step = ck.restore_checkpoint(str(tmp_path / "c"), target)
    assert got_step == 3
    for a, b in zip(tl.tree_leaves(state), tl.tree_leaves(restored)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    with pytest.raises(RuntimeError, match="latest is 3"):
        ck.save_checkpoint(str(tmp_path / "c"), state, 2)
