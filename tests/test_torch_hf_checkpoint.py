"""Checkpoint directories: the port's ``load_hf_llama(path)`` against the
reference's.

transformers writes tiny Llama (llama3-scaled RoPE), Mistral (sliding
window), Gemma (tied, explicit head_dim) and Mixtral (4 experts)
checkpoints with ``save_pretrained`` (``HF_HUB_OFFLINE=1``: nothing is
fetched) in three layouts: one ``model.safetensors``, shards under
``model.safetensors.index.json``, and ``pytorch_model.bin``; Llama also
as a bf16 safetensors file. For each:

- the port's tree at f32 is bit-equal to the reference's
  ``nos_tpu.models.convert.load_hf_llama(path, jnp.float32)`` (which
  goes through ``AutoModelForCausalLM.from_pretrained``), leaf for leaf
  through numpy;
- the config the port reads from ``config.json`` (its own reader, with
  each family's class defaults filled in) equals ``AutoConfig``'s on
  every key ``config_from_hf`` reads, and converts to the same config;
- greedy ``generate`` gives the reference's tokens exactly.

A path that is not a directory, a directory without ``config.json`` and
one without weights raise ``FileNotFoundError``.
"""
import dataclasses
import json
import os
import shutil

os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from nos_tpu.models import convert as jconv  # noqa: E402
from nos_tpu.models import generate as jg  # noqa: E402
from nos_tpu_torch.bridge import params_to_numpy  # noqa: E402
from nos_tpu_torch.models import convert as tconv  # noqa: E402
from nos_tpu_torch.models import generate as tg  # noqa: E402
from nos_tpu_torch.models import hf_files  # noqa: E402

_SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4)
_FAMILIES = {
    "llama": ("LlamaConfig", dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16})),
    "mistral": ("MistralConfig", dict(sliding_window=6)),
    "gemma": ("GemmaConfig", dict(head_dim=16)),
    "mixtral": ("MixtralConfig", dict(num_local_experts=4)),
}
_LAYOUTS = {
    "single": dict(),
    "sharded": dict(max_shard_size="40KB"),
    "bin": dict(safe_serialization=False),
    "bin_sharded": dict(safe_serialization=False, max_shard_size="40KB"),
}
_CASES = [(f, l) for f in sorted(_FAMILIES) for l in sorted(_LAYOUTS)] + [("llama", "bf16")]
# the keys config_from_hf reads
_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
         "num_attention_heads", "num_key_value_heads", "head_dim", "hidden_act",
         "rope_theta", "rope_scaling", "rms_norm_eps", "tie_word_embeddings")
_FAMILY_KEYS = {"mistral": ("sliding_window",), "gemma": ("hidden_activation",),
                "mixtral": ("sliding_window", "num_local_experts", "num_experts_per_tok")}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for family, (cls, extra) in _FAMILIES.items():
        torch.manual_seed(len(out))
        cfg = getattr(transformers, cls)(**_SMALL, **extra)
        model = transformers.AutoModelForCausalLM.from_config(cfg)
        # init norms are constants; random ones exercise their conversion
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.add_(0.1 * torch.randn_like(p))
        for layout, kwargs in _LAYOUTS.items():
            path = str(root / f"{family}-{layout}")
            model.save_pretrained(path, **kwargs)
            out[family, layout] = path
        if family == "llama":
            path = str(root / "llama-bf16")
            model.to(torch.bfloat16).save_pretrained(path)
            out["llama", "bf16"] = path
    return out


def _files(path):
    return sorted(f for f in os.listdir(path) if f != "generation_config.json")


def test_layouts_are_the_ones_named(checkpoints):
    assert _files(checkpoints["llama", "single"]) == ["config.json", "model.safetensors"]
    sharded = _files(checkpoints["mixtral", "sharded"])
    assert "model.safetensors.index.json" in sharded and len(sharded) > 3
    assert _files(checkpoints["gemma", "bin"]) == ["config.json", "pytorch_model.bin"]
    bin_sharded = _files(checkpoints["llama", "bin_sharded"])
    assert "pytorch_model.bin.index.json" in bin_sharded and len(bin_sharded) > 3
    assert hf_files.CheckpointTensors(checkpoints["llama", "bin_sharded"]).format == "torch"
    tensors = hf_files.CheckpointTensors(checkpoints["llama", "bf16"])
    assert tensors.format == "safetensors"
    assert tensors["model.embed_tokens.weight"].dtype == torch.bfloat16


@pytest.mark.parametrize("family,layout", _CASES)
def test_tree_is_bit_equal_to_the_reference_loader(checkpoints, family, layout):
    path = checkpoints[family, layout]
    want_params, want_cfg = jconv.load_hf_llama(path, jnp.float32)
    got_params, got_cfg = tconv.load_hf_llama(path, torch.float32, device="cpu")
    want = jax.tree.map(np.asarray, want_params)
    got = params_to_numpy(got_params)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    # the same config fields as the reference's (dtype aside)
    fields = [f.name for f in dataclasses.fields(want_cfg) if f.name != "dtype"]
    assert {f: getattr(got_cfg, f) for f in fields} == {
        f: getattr(want_cfg, f) for f in fields if hasattr(got_cfg, f)}
    assert got_cfg.tie_embeddings == (family == "gemma") == ("lm_head" not in got_params)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_config_equals_autoconfig(checkpoints, family):
    path = checkpoints[family, "single"]
    auto = transformers.AutoConfig.from_pretrained(path)
    read = hf_files.read_config(path)
    for key in _KEYS + _FAMILY_KEYS.get(family, ()):
        assert getattr(read, key, None) == getattr(auto, key, None), key
    assert tconv.config_from_hf(read, torch.float32) == tconv.config_from_hf(auto, torch.float32)
    if family == "gemma":  # the file leaves it out; GemmaConfig sets it
        with open(os.path.join(path, "config.json")) as f:
            assert "tie_word_embeddings" not in json.load(f)
        assert read.tie_word_embeddings is True


@pytest.mark.parametrize("family,layout", [
    ("llama", "sharded"), ("mistral", "single"), ("gemma", "bin"), ("mixtral", "sharded"),
])
def test_greedy_generate_is_token_identical(checkpoints, family, layout):
    path = checkpoints[family, layout]
    jp, jc = jconv.load_hf_llama(path, jnp.float32)
    tp, tc = tconv.load_hf_llama(path, torch.float32, device="cpu")
    prompt = np.random.default_rng(3).integers(1, 256, (2, 9)).astype(np.int32)
    want = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 8))
    got = tg.generate(tp, torch.from_numpy(prompt).long(), tc, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_missing_directory_config_or_weights_raise_file_not_found(checkpoints, tmp_path):
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        tconv.load_hf_llama(str(tmp_path / "absent"), device="cpu")
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        tconv.load_hf_llama("meta-llama/Meta-Llama-3-8B", device="cpu")
    with pytest.raises(FileNotFoundError, match="no config.json"):
        tconv.load_hf_llama(str(tmp_path), device="cpu")
    shutil.copy(os.path.join(checkpoints["llama", "single"], "config.json"), tmp_path)
    with pytest.raises(FileNotFoundError, match="no weights"):
        tconv.load_hf_llama(tmp_path, device="cpu")


def test_loading_streams_one_tensor_at_a_time(checkpoints, monkeypatch):
    """Each tensor is read from disk when the conversion asks for it,
    never all at once: no read happens before the first conversion,
    and each name is read once."""
    reads = []
    real = hf_files.CheckpointTensors.__getitem__

    def spy(self, key):
        reads.append(key)
        return real(self, key)

    monkeypatch.setattr(hf_files.CheckpointTensors, "__getitem__", spy)
    tensors = hf_files.CheckpointTensors(checkpoints["llama", "sharded"])
    assert not reads
    tconv.load_hf_llama(checkpoints["llama", "sharded"], torch.float32, device="cpu")
    assert sorted(reads) == sorted(tensors) and len(set(reads)) == len(reads)


def test_checkpoint_with_an_unsupported_family_is_refused(checkpoints, tmp_path):
    with open(os.path.join(checkpoints["llama", "single"], "config.json")) as f:
        raw = json.load(f)
    raw["model_type"] = "gpt2"
    (tmp_path / "config.json").write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="not a Llama-family"):
        hf_files.read_config(str(tmp_path))
