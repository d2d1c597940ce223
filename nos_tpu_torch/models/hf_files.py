"""A transformers checkpoint directory, read without transformers.

What ``AutoModelForCausalLM.from_pretrained`` reads for the reference's
``load_hf_llama(path)``, for the port's counterpart:

- ``config.json``, into a namespace. transformers writes only what
  differs from its config classes' defaults (a Gemma file has no
  ``tie_word_embeddings``, which ``GemmaConfig`` sets to true), so each
  family's defaults for the keys ``config_from_hf`` reads are filled in
  here, as the class would (``_FAMILY_DEFAULTS``);
- the weights: ``model.safetensors``, its shards under
  ``model.safetensors.index.json`` (the ``weight_map``), or
  ``pytorch_model.bin`` (and its ``.index.json`` shards), read with
  ``torch.load(weights_only=True, mmap=True)``.

A safetensors file is an 8-byte little-endian header length, a JSON
header (name → dtype, shape, data offsets) and then the raw bytes. Each
tensor is read alone on demand (``CheckpointTensors`` is a lazy mapping),
so a caller that moves each tensor to the device before it reads the
next holds about one tensor on the host, never the model.

Local directories only: there is no hub lookup and no network. A path
that is not a directory, or a directory with no ``config.json`` or no
weights, raises ``FileNotFoundError``.
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Dict, Iterator, Tuple

import torch

CONFIG = "config.json"
SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
TORCH_BIN_INDEX = "pytorch_model.bin.index.json"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}

# transformers 4.57's class defaults for the keys config_from_hf reads
# (LlamaConfig, MistralConfig, MixtralConfig, GemmaConfig). None for
# num_key_value_heads means "num_attention_heads", as the classes set it.
_COMMON = dict(rope_scaling=None, head_dim=None, hidden_act="silu",
               rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
               vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8)
_FAMILY_DEFAULTS = {
    "llama": dict(_COMMON, intermediate_size=11008, num_key_value_heads=None),
    "mistral": dict(_COMMON, sliding_window=4096),
    "mixtral": dict(_COMMON, rope_theta=1e6, rms_norm_eps=1e-5, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2),
    "gemma": dict(_COMMON, vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                  num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
                  head_dim=256, hidden_act="gelu_pytorch_tanh", hidden_activation=None,
                  tie_word_embeddings=True),
}


def _check_dir(path: str) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local checkpoint directory (only local "
            "directories are read: no hub lookup, no network)"
        )


def read_config(path: str) -> SimpleNamespace:
    """``config.json`` of the directory as a namespace, with the
    family's class defaults filled in where the file leaves them out."""
    _check_dir(path)
    file = os.path.join(path, CONFIG)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no {CONFIG} in checkpoint directory {path!r}")
    with open(file) as f:
        raw = json.load(f)
    family = raw.get("model_type", "llama")
    if family not in _FAMILY_DEFAULTS:
        raise ValueError(
            f"model_type {family!r} is not a Llama-family checkpoint "
            f"(known: {', '.join(sorted(_FAMILY_DEFAULTS))})"
        )
    values = dict(_FAMILY_DEFAULTS[family], **raw)
    if values["num_key_value_heads"] is None:
        values["num_key_value_heads"] = values["num_attention_heads"]
    return SimpleNamespace(**values)


def safetensors_header(file: str) -> Tuple[Dict[str, dict], int]:
    """(tensor name → {dtype, shape, data_offsets}, byte offset of the
    data) of one safetensors file."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _shard_files(path: str, index: str, single: str) -> "list[str] | None":
    if os.path.isfile(os.path.join(path, index)):
        with open(os.path.join(path, index)) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted(set(weight_map.values()))
    if os.path.isfile(os.path.join(path, single)):
        return [single]
    return None


class CheckpointTensors(Mapping):
    """Name → tensor over a checkpoint directory's weight files, each
    tensor read from disk when it is asked for (a new host tensor in the
    file's dtype, aliasing nothing). Safetensors files win over
    ``pytorch_model.bin``, as transformers prefers them.

    ``pin_memory``: a safetensors tensor is read straight into pinned
    host memory (PyTorch's caching host allocator reuses the blocks), so
    its copy to the card can run asynchronously while the next one is
    read."""

    def __init__(self, path: str, pin_memory: bool = False) -> None:
        _check_dir(path)
        self.path = path
        self.pin_memory = pin_memory
        self._where: Dict[str, Tuple[str, dict, int]] = {}
        self._bin: Dict[str, str] = {}
        self._open_bin: Tuple[str, dict] = ("", {})
        files = _shard_files(path, SAFETENSORS_INDEX, SAFETENSORS)
        if files is not None:
            self.format = "safetensors"
            for name in files:
                file = os.path.join(path, name)
                header, start = safetensors_header(file)
                for key, meta in header.items():
                    self._where[key] = (file, meta, start)
        else:
            files = _shard_files(path, TORCH_BIN_INDEX, TORCH_BIN)
            if files is None:
                raise FileNotFoundError(
                    f"no weights in checkpoint directory {path!r} (looked for "
                    f"{SAFETENSORS}, {SAFETENSORS_INDEX}, {TORCH_BIN}, {TORCH_BIN_INDEX})"
                )
            self.format = "torch"
            for name in files:
                file = os.path.join(path, name)
                for key in self._load_bin(file):
                    self._bin[key] = file

    def _load_bin(self, file: str) -> dict:
        """One ``.bin`` shard, memory-mapped; the last one stays open."""
        if self._open_bin[0] != file:
            self._open_bin = (file, torch.load(file, map_location="cpu",
                                               weights_only=True, mmap=True))
        return self._open_bin[1]

    def __getitem__(self, key: str) -> torch.Tensor:
        if key in self._bin:
            return self._load_bin(self._bin[key])[key].clone()
        file, meta, start = self._where[key]
        begin, end = meta["data_offsets"]
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{file}: tensor {key!r} has dtype {meta['dtype']}, "
                             "which the port does not read")
        # read straight into the tensor's own (uninitialised) bytes
        raw = torch.empty(end - begin, dtype=torch.uint8, pin_memory=self.pin_memory)
        with open(file, "rb") as f:
            f.seek(start + begin)
            if f.readinto(memoryview(raw.numpy())) != end - begin:
                raise ValueError(f"{file}: truncated data for tensor {key!r}")
        return raw.view(dtype).reshape(meta["shape"])

    def __contains__(self, key) -> bool:  # without reading the tensor
        return key in self._bin or key in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._bin or self._where)

    def __len__(self) -> int:
        return len(self._bin or self._where)
