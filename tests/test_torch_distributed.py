"""Port gang bootstrap, meshes, collectives and data layout
(nos_tpu_torch.parallel.{distributed,mesh,comm,sharding},
nos_tpu_torch.data under a mesh) against the reference.

The env-coordinate helpers are held against the reference's own
(``nos_tpu.parallel.distributed``), as ``tests/parallel/test_distributed.py``
holds them. Everything that needs a process group runs on gloo ranks
spawned once per test (``tests/torch_sp_ranks.py``): ``initialize`` from
gang coordinates at a free localhost port, the mesh builders, the ring
shift, the tiled all-to-all (against a numpy model of
``lax.all_to_all(tiled=True)``) with their autograd backward, the
all-reduce, the loader's dp striding (against the reference's loader)
and what still raises under a mesh. Exact comparisons: these move and
add small integers.
"""
import socket

import jax
import numpy as np
import pytest
import torch

from nos_tpu.data import BatchLoader as JaxBatchLoader
from nos_tpu.models import llama as jl
from nos_tpu.parallel import distributed as jd
from nos_tpu_torch.parallel import distributed as td
from nos_tpu_torch.parallel import sharding
from tests import torch_sp_ranks as ranks

_INVALID = [
    {},
    {td.COORDINATOR_ENV: "x:1"},  # missing rank and size
    {td.COORDINATOR_ENV: "x:1", td.NUM_PROCESSES_ENV: "4", td.PROCESS_ID_ENV: "9"},
    {td.COORDINATOR_ENV: "x:1", td.NUM_PROCESSES_ENV: "bad", td.PROCESS_ID_ENV: "0"},
    {td.COORDINATOR_ENV: "", td.NUM_PROCESSES_ENV: "4", td.PROCESS_ID_ENV: "0"},
]


class TestEnvCoordinates:
    def test_names_and_port_are_the_reference_s(self):
        assert (td.COORDINATOR_ENV, td.NUM_PROCESSES_ENV, td.PROCESS_ID_ENV,
                td.DEFAULT_COORDINATOR_PORT) == (
            jd.COORDINATOR_ENV, jd.NUM_PROCESSES_ENV, jd.PROCESS_ID_ENV,
            jd.DEFAULT_COORDINATOR_PORT)

    @pytest.mark.parametrize("rank,size,port", [(2, 4, None), (0, 1, None), (3, 8, 9000)])
    def test_roundtrip_matches_reference(self, rank, size, port):
        kw = {} if port is None else {"port": port}
        env = td.gang_member_env("big", "ml", rank=rank, size=size, **kw)
        assert env == jd.gang_member_env("big", "ml", rank=rank, size=size, **kw)
        assert td.env_coordinates(env) == (
            f"big.big.ml.svc:{port or 8476}", size, rank)

    @pytest.mark.parametrize("env", _INVALID)
    def test_invalid_coordinates(self, env):
        assert td.env_coordinates(env) is None
        assert jd.env_coordinates(env) is None

    def test_initialize_is_noop_without_coordinates(self):
        assert td.initialize({}, device="cpu") is False

    def test_initialize_is_noop_for_size_one(self):
        env = td.gang_member_env("solo", "ml", rank=0, size=1)
        assert td.initialize(env, device="cpu") is False


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_starts_a_gloo_group_from_gang_coordinates(tmp_path):
    env = {td.COORDINATOR_ENV: f"localhost:{free_port()}", td.NUM_PROCESSES_ENV: "2"}
    ranks.spawn(ranks.initialize_from_env, 2, tmp_path, tmp_path, env, init=False)
    for rank in range(2):
        got = ranks.load(tmp_path, "init", rank)
        assert bool(got["started"]) and int(got["rank"]) == rank
        assert int(got["world"]) == 2 and str(got["backend"]) == "gloo"
        assert float(got["total"][0]) == 1.0  # 0 + 1
        assert int(got["sp_index"]) == rank


def test_mesh_builders(tmp_path):
    """The default training mesh and the slice meshes have the
    reference's axis names and sizes on four devices."""
    from nos_tpu.parallel import mesh as jm

    devices = jax.devices()[:4]
    want_default = jm.default_training_mesh(devices)
    want_slices = {"slice_2x2": jm.mesh_for_slice("2x2", devices=devices),
                   "slice_1x4": jm.mesh_for_slice("1x4", devices=devices),
                   "slice_2x2_dp4": jm.mesh_for_slice("2x2", dp=4, devices=devices)}
    ranks.spawn(ranks.mesh_builders, 4, tmp_path, tmp_path)
    for rank in range(4):
        got = ranks.load(tmp_path, "mesh", rank)
        # the reference's axis order and sizes: tp 2 innermost, then sp
        assert list(got["default_names"]) == list(want_default.axis_names)
        assert list(got["default_shape"]) == [want_default.shape[a] for a in want_default.axis_names]
        assert list(got["sizes"]) == [1, 2, 2]
        assert list(got["coords"]) == [0, rank // 2, rank % 2]
        for key, want in want_slices.items():
            assert list(got[f"{key}_names"]) == list(want.axis_names), key
            assert list(got[f"{key}_shape"]) == [want.shape[a] for a in want.axis_names], key
        assert int(got["global_sp"]) == rank
        assert list(got["absent"]) == [0, 1]
        assert "need 8 devices" in str(got["too_big"])
        assert str(got["slice_dp3"]).startswith("ValueError") and "does not divide" in str(got["slice_dp3"])
        assert str(got["slice_bad"]).startswith("ValueError") and "invalid topology" in str(got["slice_bad"])


def test_collectives(tmp_path):
    """Rank r = 2·dp + sp on a (2, 2) mesh; the sp group of rank r is
    {2·dp, 2·dp + 1}."""
    ranks.spawn(ranks.comm_ops, 4, tmp_path, tmp_path)
    got = [ranks.load(tmp_path, "comm", r) for r in range(4)]
    for r in range(4):
        base = r - r % 2
        prev = next_ = base + (r + 1) % 2  # a ring of two: both neighbours
        g = got[r]
        assert str(g["transport"]) == "gloo"
        np.testing.assert_array_equal(g["fwd0"], np.full((3, 5), float(prev)))
        np.testing.assert_array_equal(g["fwd1"], np.arange(7) + prev)
        np.testing.assert_array_equal(g["fwd2"], np.full((2, 2), 10 * prev))
        np.testing.assert_array_equal(g["back0"], np.full((3, 5), float(next_)))
        # tiled all-to-all: chunk j of the heads goes to sp rank j, the
        # sequence chunks arrive in rank order
        members = [base, base + 1]
        want = np.concatenate(
            [np.split(got[m]["x"], 2, axis=2)[r % 2] for m in members], axis=1)
        np.testing.assert_array_equal(g["gathered"], want)
        np.testing.assert_array_equal(g["restored"], g["x"])
        # d/dx of sum(shift(x) * (r + 1)) on the sender is the receiver's weight
        np.testing.assert_array_equal(g["shift_grad"], np.full(2, float(next_ + 1)))
        # the backward of the all-to-all sends each gradient chunk home:
        # sp rank i's positions are gathered ones 4i..4i+3, for both of
        # the head halves it sent out
        weight = np.broadcast_to(np.arange(8.0).reshape(1, 8, 1, 1), (1, 8, 2, 2))
        want_grad = np.concatenate([np.split(weight, 2, axis=1)[r % 2]] * 2, axis=2)
        np.testing.assert_array_equal(g["a2a_grad"], want_grad)
        assert float(g["sum_mesh"][0]) == 10.0 and float(g["mean_mesh"][0]) == 2.5
        assert float(g["sum_sp"][0]) == float(base + 1 + base + 2)
        assert float(g["one_after"][0]) == r + 1  # the input is left alone


def test_data_sharding_takes_the_rank_block():
    class FakeMesh:
        mesh_dim_names = ("dp", "sp")
        shape = (2, 4)

        def __init__(self, dp, sp):
            self.coords = {"dp": dp, "sp": sp}

        def get_local_rank(self, name):
            return self.coords[name]

    tokens = torch.arange(4 * 16).reshape(4, 16)
    for dp in range(2):
        for sp in range(4):
            got = sharding.llama_data_sharding(FakeMesh(dp, sp), tokens)
            assert torch.equal(got, tokens[2 * dp:2 * dp + 2, 4 * sp:4 * sp + 4])
            rows = tokens[2 * dp:2 * dp + 2]
            assert torch.equal(sharding.sequence_block(FakeMesh(dp, sp), rows), got)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.llama_data_sharding(FakeMesh(0, 0), tokens[:, :15])


def test_loader_strides_by_dp_and_prefetch_delivers_the_block(tmp_path):
    corpus = np.random.default_rng(0).integers(0, 1000, size=5000).astype(np.int32)
    ranks.spawn(ranks.loader_blocks, 4, tmp_path, tmp_path, corpus)
    for r in range(4):
        got = ranks.load(tmp_path, "loader", r)
        dp, sp = int(got["dp"]), int(got["sp"])
        assert (dp, sp) == (r // 2, r % 2)
        assert list(got["grid_mesh"]) == [dp, 2] and list(got["grid_world"]) == [r, 4]
        # both sp ranks of a dp group draw the reference loader's rows
        # for process dp of 2
        ref = JaxBatchLoader(corpus, batch=4, seq_len=16, seed=5,
                             process_index=dp, process_count=2)
        want = np.stack([b for _, b in zip(range(2), ref)])
        np.testing.assert_array_equal(got["rows"], want)
        np.testing.assert_array_equal(got["blocks"], want[:, :, 8 * sp:8 * sp + 8])


def test_out_of_slice_paths_raise_naming_item_9(tmp_path):
    jp = jl.init_llama_params(jax.random.key(0), jl.tiny_config(dtype=np.float32))
    params_np = jax.tree.map(np.asarray, jp)
    ranks.spawn(ranks.out_of_slice, 4, tmp_path, tmp_path, params_np)
    raising = {
        "forward_not_a_mesh": ("TypeError", "DeviceMesh"),
        "forward_unknown_axis": ("ValueError", "mesh axes"),
        "lora_shards": ("NotImplementedError", "shard the base"),
        "engine_multi_lora": ("NotImplementedError", "multi-LoRA serving under a mesh"),
        "engine_kv_quant": ("ValueError", "kv_quant + mesh"),
    }
    for r in range(4):
        errors = {k: str(v) for k, v in ranks.load(tmp_path, "out_of_slice", r).items()}
        assert len(errors) == 15
        for key, text in errors.items():
            assert "item 9" not in text, (key, text)
            if key in raising:
                kind, phrase = raising[key]
                assert text.startswith(kind) and phrase in text, (key, text)
            else:  # expert parallelism, LoRA and SpecEngine under a mesh now run
                assert text == "no error", (key, text)
