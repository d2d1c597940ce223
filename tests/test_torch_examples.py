"""The port's examples (nos_tpu_torch.examples) on the CPU.

- Each example's ``main`` runs on the CPU and returns finite numbers:
  serve_llama with the tiny model (its rolling window, speculative and
  multi-LoRA demos included) and from a checkpoint directory;
  train_llama with its checkpoints and a resume that continues the
  uninterrupted run's losses exactly; finetune_lora.
- train_llama's optimizer (``ClippedAdamW``: global-norm clipping, then
  AdamW) against the reference's ``optax.chain(clip_by_global_norm,
  adamw)`` through each side's ``make_train_step``, on weights bridged
  from the reference's f32 tiny init, three steps. Tolerances: losses
  within 1e-5 and the first step's global norm within 1e-5 relative
  (the same arithmetic, other summation orders); params within 1e-5 in
  the case that forces the clip every step with eps 1e-3 (see
  tests/test_torch_train.py's AdamW test for why a tiny eps would let
  gradient noise pick a full +-lr step).
- On two gloo ranks: one ``ClippedAdamW`` step over tp 2 and over dp 2
  (FSDP), against optax on the whole tree (the norm sums each sharded
  leaf's squares over its ranks and counts replicated leaves once;
  norm and clipped gradients within 1e-6 relative, params within 1e-5),
  and the example's ``main`` over its (dp 1, tp 2) mesh, whose losses
  match one process's within 1e-3: the example trains its bf16 model,
  and under tp each rank rounds its row-parallel partial to bf16 before
  the f32 sum (ROADMAP Queue 3, "tp sums in another order"; the same bar
  as the card's tp phases).
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
from nos_tpu_torch.examples import finetune_lora, serve_llama, train_llama
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.llama import tree_leaves
from tests import torch_sp_ranks as ranks
from tests import torch_tp_ranks as tp_ranks

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
NORM_RTOL = 1e-5
TP_BF16_LOSS_ATOL = 1e-3


def _finite(values) -> bool:
    return bool(np.all(np.isfinite(np.asarray(values, dtype=np.float64))))


def test_serve_llama_main_runs_every_demo_on_the_cpu():
    out = serve_llama.main(["--device", "cpu"])
    assert out["int8_bytes"] < 0.6 * out["dense_bytes"]
    assert out["engine"]["requests"] == 8 and out["engine"]["tokens"] == 8 * 16
    assert out["engine"]["prefix_hits"] >= 1 and _finite([out["engine"]["tokens_per_s"]])
    assert out["rolling_positions"] == 40 + 120
    assert out["speculative"]["rounds"] > 0 and _finite([out["speculative"]["mean_accepted"]])
    assert out["multi_lora_tokens"] == [8, 8, 8]
    assert len(out["sampled"]) == 12 and all(0 <= t < 256 for t in out["sampled"])


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=8,
                                   num_key_value_heads=4)
    path = str(tmp_path_factory.mktemp("hf") / "llama")
    transformers.AutoModelForCausalLM.from_config(cfg).save_pretrained(path)
    return path


def test_serve_llama_from_a_checkpoint_directory(hf_dir):
    out = serve_llama.main(["--device", "cpu", "--real-weights", hf_dir, "--slots", "2"])
    assert out["engine"]["tokens"] == 4 * 16
    assert "rolling_positions" not in out  # the tiny-model demos are skipped
    assert len(out["sampled"]) == 12


def test_finetune_lora_main_trains_merges_and_serves():
    out = finetune_lora.main(["--device", "cpu", "--steps", "6", "--rank", "4"])
    assert _finite(out["losses"]) and out["losses"][-1] < out["losses"][0]
    assert 0 < out["trainable"] < out["base"]
    assert len(out["tokens"]) == 12


def test_train_llama_main_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "run")
    first = train_llama.main(["--device", "cpu", "--steps", "6", "--checkpoint-every", "3",
                              "--ckpt-dir", ckpt])
    assert first["start_step"] == 0 and first["latest_checkpoint"] == 6
    assert sorted(first["losses"]) == list(range(1, 7)) and _finite(list(first["losses"].values()))
    assert first["config"]["attention"] == "dense" and first["mesh"] is None
    resumed = train_llama.main(["--device", "cpu", "--steps", "9", "--checkpoint-every", "3",
                                "--ckpt-dir", ckpt])
    assert resumed["start_step"] == 6 and sorted(resumed["losses"]) == [7, 8, 9]
    whole = train_llama.main(["--device", "cpu", "--steps", "9", "--checkpoint-every", "3",
                              "--ckpt-dir", str(tmp_path / "whole")])
    # batch N after the restart is batch N of the uninterrupted run
    for step in (7, 8, 9):
        assert resumed["losses"][step] == whole["losses"][step]
    assert whole["losses"][9] < whole["losses"][1]


def test_card_config_is_what_the_kernels_take():
    cfg = train_llama.card_config()
    assert cfg.head_dim == 64 and cfg.attention == "flash" and cfg.remat
    assert cfg.dtype == torch.bfloat16


def _tokens(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


_HYPER = {
    # the example's own settings: clip at 1.0, AdamW(3e-3, wd 0.01), eps 1e-8
    "example": (dict(max_norm=1.0), dict(learning_rate=3e-3, weight_decay=0.01)),
    # a clip that binds every step, and eps well above the gradient noise
    "forced_clip": (dict(max_norm=0.05),
                    dict(learning_rate=1e-2, b1=0.8, b2=0.95, eps=1e-3, weight_decay=0.1)),
}


@pytest.mark.parametrize("case", sorted(_HYPER))
def test_train_steps_with_the_clip_match_optax(case):
    clip, adamw = _HYPER[case]
    jc = jl.tiny_config(dtype=jnp.float32)
    tc = tl.tiny_config(dtype=torch.float32)
    jp = jl.init_llama_params(jax.random.key(3), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    batches = [_tokens(10 + i) for i in range(3)]
    want_norm = float(optax.global_norm(jax.grad(
        lambda p: jl.llama_loss(p, jnp.asarray(batches[0]), jc))(jp)))

    chain = optax.chain(optax.clip_by_global_norm(clip["max_norm"]), optax.adamw(**adamw))
    jstep, jshard = jax_make_train_step(
        mesh_from_devices((1, 1), ("dp", "tp"), jax.devices()[:1]), jc, optimizer=chain)
    torch_adamw = dict(lr=adamw["learning_rate"], weight_decay=adamw["weight_decay"])
    if "eps" in adamw:
        torch_adamw.update(betas=(adamw["b1"], adamw["b2"]), eps=adamw["eps"])
    pstep, pstate = train_llama.build(tc, tp, None, "cpu", max_norm=clip["max_norm"],
                                      **torch_adamw)
    jstate = jshard(jp)
    for i, toks in enumerate(batches):
        jstate, jloss = jstep(jstate, jnp.asarray(toks))
        pstate, ploss = pstep(pstate, torch.from_numpy(toks))
        assert abs(float(ploss) - float(jloss)) <= LOSS_ATOL, i
        if i == 0:
            got_norm = float(pstate[1].last_norm)
            assert abs(got_norm - want_norm) <= NORM_RTOL * want_norm
            if case == "forced_clip":
                assert want_norm > 4 * clip["max_norm"]  # the clip binds
    if case == "forced_clip":
        want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jstate[0]), tc,
                                             device="cpu"))
        for g, w in zip(tree_leaves(pstate[0]), want):
            assert float((g.detach() - w).abs().max()) <= PARAM_ATOL


def _clip_reference(params_np, grads_np, max_norm, adamw):
    """optax's clip + AdamW step on the whole trees: (norm, clipped
    grads, stepped params) as numpy trees."""
    chain = optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(**adamw))
    params = jax.tree.map(jnp.asarray, params_np)
    grads = jax.tree.map(jnp.asarray, grads_np)
    clipped, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    updates, _ = chain.update(grads, chain.init(params), params)
    stepped = optax.apply_updates(params, updates)
    return (float(optax.global_norm(grads)), jax.tree.map(np.asarray, clipped),
            jax.tree.map(np.asarray, stepped))


def test_clipped_adamw_over_tp2_and_fsdp_dp2_matches_optax(tmp_path):
    jc = jl.tiny_config(dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(5), jc))
    rng = np.random.default_rng(6)
    grads_np = jax.tree.map(
        lambda x: (0.05 * rng.standard_normal(x.shape)).astype(np.float32), params_np)
    max_norm = 1.0
    hyper = dict(max_norm=max_norm, lr=1e-2, betas=(0.8, 0.95), eps=1e-3, weight_decay=0.1)
    norm, clipped, stepped = _clip_reference(
        params_np, grads_np, max_norm,
        dict(learning_rate=1e-2, b1=0.8, b2=0.95, eps=1e-3, weight_decay=0.1))
    assert norm > 2 * max_norm  # the clip binds
    meshes = [(1, 2), (2, 1)]
    ranks.spawn(tp_ranks.example_clip, 2, tmp_path, tmp_path, params_np, grads_np,
                meshes, hyper)
    tc = tl.tiny_config(dtype=torch.float32)

    def leaves(tree):
        return [t.numpy() for t in tree_leaves(params_from_numpy(tree, tc, device="cpu"))]

    want_g, want_p = leaves(clipped), leaves(stepped)
    for dims in meshes:
        for rank in range(2):
            got = ranks.load(tmp_path, f"clip_{dims[0]}x{dims[1]}", rank)
            assert abs(float(got["norm"]) - norm) <= 1e-6 * norm, dims
            scale = max(np.abs(w).max() for w in want_g)
            for i, w in enumerate(want_g):
                assert np.abs(got[f"g{i}"] - w).max() <= 1e-6 * scale, (dims, i)
            for i, w in enumerate(want_p):
                assert np.abs(got[f"p{i}"] - w).max() <= PARAM_ATOL, (dims, i)


def test_train_llama_main_over_a_tp2_mesh_matches_one_process(tmp_path):
    steps = 3
    one = train_llama.main(["--device", "cpu", "--steps", str(steps),
                            "--ckpt-dir", str(tmp_path / "one")])
    out = tmp_path / "tp2"
    os.makedirs(out)
    ranks.spawn(tp_ranks.example_train, 2, out, out, steps)
    want = np.array([one["losses"][k] for k in sorted(one["losses"])])
    for rank in range(2):
        got = ranks.load(out, "example_train", rank)
        assert dict(got["mesh"].tolist()) == {"dp": "1", "tp": "2"}
        assert np.abs(got["losses"] - want).max() <= TP_BF16_LOSS_ATOL
        assert int(got["latest"]) == 2
