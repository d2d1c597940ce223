"""Weights from the reference into the port, through numpy.

``params_from_numpy`` takes a ``nos_tpu`` Llama parameter tree whose
leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, params)`` on
the caller's side; this module never imports jax) and returns the port's
dict with the same keys and the same ``[in, out]`` layout. Dense leaves
are cast to ``config.dtype``, except a MoE layer's router, which keeps
its own (f32) dtype; bf16 leaves arrive as ``ml_dtypes`` arrays that
torch cannot read and are widened to f32 (exact) first.

The reference's weight nodes arrive as its own classes with numpy
fields. They are recognised by their fields, never by importing their
classes, and each field keeps its own dtype (int8 ``q``, uint8 packed
nibbles, f32 scales and adapters, an int row selector):

- ``q``, ``scale``, ``group`` → ``QuantizedLinear4``;
- ``q``, ``scale`` → ``QuantizedEmbedding`` at ``embed``,
  ``QuantizedExpertStack`` in a ``moe`` node, else ``QuantizedLinear``;
- ``w``, ``a``, ``b``, ``idx``, ``scale`` → ``MultiLoraLinear``;
- ``w``, ``a``, ``b``, ``scale`` → ``LoraLinear``.

The pipeline's stacked layout (``parallel/pipeline.py:stack_layer_params``,
the reference's own, ``layers`` a dict of ``[L, ...]`` leaves) converts
the same way, leaf for leaf.

``params_to_numpy`` goes the other way, so a caller can hold the port's
params against the reference's after a training step: f32 leaves come
back as f32 arrays and bf16 leaves as ``ml_dtypes.bfloat16`` arrays
(jax's own bf16 numpy type), bit for bit. A velocity tree has the
params' structure and crosses through ``params_from_numpy`` as it is.
``lora_from_numpy`` / ``lora_to_numpy`` carry adapter trees
(``{"layers": [{target: {"a", "b"}}]}``) both ways in their own dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import LlamaConfig, tree_map
from nos_tpu_torch.models.lora import LoraLinear, MultiLoraLinear
from nos_tpu_torch.models.quantize import (
    QuantizedEmbedding,
    QuantizedExpertStack,
    QuantizedLinear,
    QuantizedLinear4,
)

_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
# a dense layer's MLP, or the expert stacks of a ``moe`` node
_MLP_KEYS = ("w_gate", "w_up", "w_down")
# numpy dtypes torch.from_numpy reads as they are
_TORCH_READS = {np.dtype(t) for t in (
    np.float16, np.float32, np.float64, np.int8, np.int16, np.int32,
    np.int64, np.uint8, np.bool_,
)}


def _exact(leaf: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (ml_dtypes bf16 as
    torch bf16), copied: the port never aliases the caller's arrays."""
    leaf = np.asarray(leaf)
    if leaf.dtype in _TORCH_READS:
        return torch.tensor(leaf, device=device)
    if leaf.dtype.name == "bfloat16":
        return torch.tensor(leaf.view(np.int16), device=device).view(torch.bfloat16)
    raise TypeError(f"leaf of numpy dtype {leaf.dtype} has no torch twin")


def _tensor(leaf, name: str, config: LlamaConfig, device):
    if isinstance(leaf, np.ndarray):
        if leaf.dtype not in _TORCH_READS:
            leaf = leaf.astype(np.float32)
        return torch.tensor(leaf, dtype=config.dtype, device=device)
    fields = set(vars(leaf)) if hasattr(leaf, "__dict__") else set()
    if {"q", "scale", "group"} <= fields:
        return QuantizedLinear4(q=_exact(leaf.q, device), scale=_exact(leaf.scale, device),
                                group=int(leaf.group))
    if {"q", "scale"} <= fields:
        if name == "embed":
            node = QuantizedEmbedding
        elif ".moe." in name:  # the same fields, over [E, in, out]
            node = QuantizedExpertStack
        else:
            node = QuantizedLinear
        return node(q=_exact(leaf.q, device), scale=_exact(leaf.scale, device))
    if {"w", "a", "b", "scale"} <= fields:
        parts = dict(w=_tensor(leaf.w, f"{name}.w", config, device),
                     a=_exact(leaf.a, device), b=_exact(leaf.b, device),
                     scale=float(leaf.scale))
        if "idx" in fields:
            return MultiLoraLinear(idx=_exact(leaf.idx, device), **parts)
        return LoraLinear(**parts)
    raise TypeError(f"{name}: unrecognised params leaf of type {type(leaf).__name__}")


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig, device=None):
    """nos_tpu params (numpy leaves) → the port's params on ``device``."""
    dev = _resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _tensor(tree["embed"], "embed", config, dev),
        "final_norm": _tensor(tree["final_norm"], "final_norm", config, dev),
        "layers": [],
    }
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], "lm_head", config, dev)
    if isinstance(tree["layers"], dict):  # the stacked layout
        out["layers"] = _layer(tree["layers"], "layers", config, dev)
        return out
    for i, layer in enumerate(tree["layers"]):
        out["layers"].append(_layer(layer, f"layers[{i}]", config, dev))
    return out


def _layer(layer, name: str, config: LlamaConfig, dev) -> Dict[str, Any]:
    """One layer's leaves (or the stacked layers', each [L, ...])."""
    ported = {key: _tensor(layer[key], f"{name}.{key}", config, dev) for key in _ATTN_KEYS}
    if "moe" in layer:
        moe = layer["moe"]
        ported["moe"] = {"router": _exact(moe["router"], dev)}
        ported["moe"].update({
            key: _tensor(moe[key], f"{name}.moe.{key}", config, dev) for key in _MLP_KEYS
        })
    else:
        ported.update({key: _tensor(layer[key], f"{name}.{key}", config, dev)
                       for key in _MLP_KEYS})
    return ported


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # jax's bf16 numpy type; only this direction needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params (or a tree of their shape) → the same tree with
    numpy leaves on the host, each leaf's bits unchanged."""
    return tree_map(_array, params)


def lora_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """An adapter tree with numpy leaves → tensors on ``device``, each in
    its own dtype (the reference's adapters are f32)."""
    dev = _resolve_device(device)
    return {"layers": [
        {t: {ab: _exact(arr, dev) for ab, arr in target.items()}
         for t, target in layer.items()}
        for layer in tree["layers"]
    ]}


# an adapter tree walks like a params tree
lora_to_numpy = params_to_numpy
