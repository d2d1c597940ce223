"""ResNet-50 in PyTorch, on ``channels_last``.

Counterpart of ``nos_tpu/models/resnet.py`` (``BASELINE.json``'s config
#3): bottleneck blocks with the stride on the 3x3 conv (ResNet v1.5),
folded batch-norm (scale and bias only), images ``[B, H, W, 3]`` and f32
logits. The tree has the reference's shape: ``stem`` {conv, norm}, a
list of ``stages``, each a list of block dicts (conv1..3, norm1..3, and
``proj`` / ``proj_norm`` on a stage's first block), and ``head``
``[C, classes]``. A conv kernel is ``[O, I, kh, kw]`` in channels_last
memory (the reference's HWIO, permuted; ``bridge.resnet_params_from_numpy``
converts).

``images.permute(0, 3, 1, 2)`` is already a channels_last NCHW view, so
the network runs on the images' own memory. The convolutions are
``F.conv2d`` (cuDNN on the card): in the reference they are XLA
convolutions, not Pallas kernels.

Padding is XLA's ``"SAME"``: ``out = ceil(n / s)``, ``pad = max((out - 1)
* s + k - n, 0)``, ``lo = pad // 2``, ``hi = pad - lo``. Under stride 2
it is asymmetric: (2, 3) for the 7x7 stem at 224, (0, 1) for a 3x3 conv
or the 3x3 max-pool at an even size. PyTorch's ``padding=`` is
symmetric, so such a pad goes through ``F.pad`` first (with -inf before
the max-pool).

Rounding follows the reference: each conv, norm and residual add in the
model dtype, the spatial mean accumulated in f32 and returned in the
model dtype (``jnp.mean``), the head's product in the model dtype and
only then widened to f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch import _resolve_device

Params = Dict[str, Any]


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


def tiny_resnet_config() -> ResNetConfig:
    return ResNetConfig(num_classes=10, stage_sizes=(1, 1), width=8)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" (lo, hi) padding of one spatial dim of size ``n``
    for a window ``k`` at stride ``s``."""
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """(x padded where "SAME" is asymmetric, the symmetric pad left to
    the op). ``F.pad`` keeps the channels_last layout."""
    (top, bottom), (left, right) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    x, padding = _pad_same(x, kernel.shape[2], stride)
    return F.conv2d(x, kernel, stride=stride, padding=padding)


def _norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    # folded batch-norm over the channel dim (dim 1 of the NCHW view)
    return x * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def _bottleneck(x: torch.Tensor, block: Params, stride: int) -> torch.Tensor:
    shortcut = x
    y = F.relu(_norm(_conv(x, block["conv1"]), block["norm1"]))
    y = F.relu(_norm(_conv(y, block["conv2"], stride=stride), block["norm2"]))
    y = _norm(_conv(y, block["conv3"]), block["norm3"])
    if "proj" in block:
        shortcut = _norm(_conv(x, block["proj"], stride=stride), block["proj_norm"])
    return F.relu(y + shortcut)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    x, padding = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=padding)


def resnet_forward(params: Params, images: torch.Tensor, config: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] → logits [B, num_classes] (float32)."""
    x = images.to(config.dtype).permute(0, 3, 1, 2)  # a channels_last view
    x = F.relu(_norm(_conv(x, params["stem"]["conv"], stride=2), params["stem"]["norm"]))
    x = _max_pool(x)
    for stage_index, stage in enumerate(params["stages"]):
        for block_index, block in enumerate(stage):
            stride = 2 if (stage_index > 0 and block_index == 0) else 1
            x = _bottleneck(x, block, stride)
    x = x.float().mean(dim=(2, 3)).to(config.dtype)
    return (x @ params["head"]).float()


# ------------------------------------------------------------------- init


def _conv_init(gen: torch.Generator, kh, kw, cin, cout, dtype) -> torch.Tensor:
    w = torch.randn((cout, kh, kw, cin), generator=gen, device=gen.device)
    w = w.mul_(math.sqrt(2.0 / (kh * kw * cin))).to(dtype)
    return w.permute(0, 3, 1, 2)  # [O, I, kh, kw], channels_last memory


def _norm_params(cout: int, dtype, device) -> Params:
    return {"scale": torch.ones((cout,), dtype=dtype, device=device),
            "bias": torch.zeros((cout,), dtype=dtype, device=device)}


def init_resnet_params(gen: torch.Generator, config: ResNetConfig, device=None) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (He-normal convs,
    unit-scale folded norms, a 1/sqrt(C) head); ``gen`` must live on that
    device. Not the reference's numbers (``jax.random`` has no torch
    twin): to hold the port against it, bridge its weights
    (``bridge.resnet_params_from_numpy``)."""
    c = config
    dev = _resolve_device(device)
    if gen.device.type != dev.type or dev.index not in (None, gen.device.index):
        raise ValueError(f"the generator is on {gen.device}, the weights go to {dev}")
    params: Params = {
        "stem": {"conv": _conv_init(gen, 7, 7, 3, c.width, c.dtype),
                 "norm": _norm_params(c.width, c.dtype, dev)},
        "stages": [],
    }
    cin = c.width
    for stage_index, blocks in enumerate(c.stage_sizes):
        stage: List[Params] = []
        width = c.width * (2 ** stage_index)
        cout = width * 4
        for block_index in range(blocks):
            block = {
                "conv1": _conv_init(gen, 1, 1, cin, width, c.dtype),
                "norm1": _norm_params(width, c.dtype, dev),
                "conv2": _conv_init(gen, 3, 3, width, width, c.dtype),
                "norm2": _norm_params(width, c.dtype, dev),
                "conv3": _conv_init(gen, 1, 1, width, cout, c.dtype),
                "norm3": _norm_params(cout, c.dtype, dev),
            }
            if block_index == 0:
                block["proj"] = _conv_init(gen, 1, 1, cin, cout, c.dtype)
                block["proj_norm"] = _norm_params(cout, c.dtype, dev)
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    head = torch.randn((cin, c.num_classes), generator=gen, device=dev)
    params["head"] = head.div_(math.sqrt(cin)).to(c.dtype)
    return params

