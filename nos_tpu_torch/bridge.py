"""Weights from the reference into the port, through numpy.

``params_from_numpy`` takes a ``nos_tpu`` Llama parameter tree whose
leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, params)`` on
the caller's side; this module never imports jax) and returns the port's
dict with the same keys and the same ``[in, out]`` layout. bf16 leaves
arrive as ``ml_dtypes`` arrays that torch cannot read: they are widened
to f32 (exact) and cast to ``config.dtype``.

``params_to_numpy`` goes the other way, so a caller can hold the port's
params against the reference's after a training step: f32 leaves come
back as f32 arrays and bf16 leaves as ``ml_dtypes.bfloat16`` arrays
(jax's own bf16 numpy type), bit for bit. A velocity tree has the
params' structure and crosses through ``params_from_numpy`` as it is.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import LlamaConfig, _check_slice, tree_map

_LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
)
# numpy dtypes torch.from_numpy reads as they are
_TORCH_READS = {np.dtype(t) for t in (
    np.float16, np.float32, np.float64, np.int8, np.int16, np.int32,
    np.int64, np.uint8, np.bool_,
)}


def _tensor(leaf, name: str, config: LlamaConfig, device) -> torch.Tensor:
    if not isinstance(leaf, np.ndarray):
        raise NotImplementedError(
            f"{name}: leaf of type {type(leaf).__name__}; quantized / LoRA "
            "leaves are not ported yet (ROADMAP Queue 1 item 8)"
        )
    if leaf.dtype not in _TORCH_READS:
        leaf = leaf.astype(np.float32)
    # torch.tensor copies: the port's weights never alias the caller's
    # (possibly read-only) arrays
    return torch.tensor(leaf, dtype=config.dtype, device=device)


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig, device=None):
    """nos_tpu params (numpy leaves) → the port's params on ``device``."""
    _check_slice(config)
    dev = _resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _tensor(tree["embed"], "embed", config, dev),
        "final_norm": _tensor(tree["final_norm"], "final_norm", config, dev),
        "layers": [],
    }
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], "lm_head", config, dev)
    for i, layer in enumerate(tree["layers"]):
        if "moe" in layer:
            raise NotImplementedError(
                f"layers[{i}].moe: routed MoE is not ported yet "
                "(ROADMAP Queue 1 item 8: serving extensions, moe.py)"
            )
        out["layers"].append({
            key: _tensor(layer[key], f"layers[{i}].{key}", config, dev)
            for key in _LAYER_KEYS
        })
    return out


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
