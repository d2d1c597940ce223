"""Ulysses sequence parallelism: an all-to-all head / sequence exchange.

Counterpart of ``nos_tpu/parallel/ulysses.py``. Where the ring keeps
queries in place and passes K/V blocks in n − 1 hops, Ulysses scatters
the heads over the ``sp`` ranks while gathering the whole sequence (one
all-to-all for each of q, k, v), runs ordinary attention per head group
on the whole sequence, and inverts the exchange. Each rank then holds
the full sequence for H/n heads: it scales context by shrinking heads a
rank, the ring by shrinking the sequence a rank.

``attention="flash"`` runs ``flash_attention`` (the ``_FlashAttention``
Function) on the gathered sequence, so both directions run the kernels;
``"dense"`` the model's GQA einsum. Differentiable end to end: the
exchange's backward is the inverse exchange (``comm.AllToAll``).

Takes and returns the rank's block: q/k/v ``[B, S/n, H, hd]`` in,
``[B, S/n, Hq·hd]`` out. Under tensor parallelism H is the rank's own
``H/tp`` heads, so the head counts that must divide by sp are those.
"""
from __future__ import annotations

from typing import Optional

import torch

from nos_tpu_torch.ops.flash_attention import flash_attention, validate_window
from nos_tpu_torch.parallel.comm import AllToAll
from nos_tpu_torch.parallel.mesh import axis_size


def _dense_causal(q, k, v, causal, window=None):
    """GQA attention on a whole local sequence through the model's one
    GQA einsum (``llama.gqa_dense_attention``)."""
    from nos_tpu_torch.models.llama import _window_causal_mask, gqa_dense_attention

    mask = _window_causal_mask(q.shape[1], window, q.device) if causal else None
    return gqa_dense_attention(q, k, v, mask)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    attention: str = "dense",
    window: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention of this rank's q/k/v blocks ``[B, S/n, H, hd]``
    over the sequence sharded on ``axis_name`` → ``[B, S/n, Hq·hd]``;
    the calling convention of ``ring_attention``.

    Raises (never mis-groups): the rank's Q and KV head counts must divide by
    the sp degree, which also keeps every head chunk on whole GQA groups
    (a single kv head, as Gemma-2B's, rules Ulysses out at sp > 1: use
    the ring); the mesh must have the sequence axis."""
    validate_window(causal, window)
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no sequence axis {axis_name!r}")
    n = axis_size(mesh, axis_name)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n or hkv % n:
        raise ValueError(
            f"ulysses needs per-device head counts divisible by sp={n} "
            f"(q {hq}, kv {hkv}); use ring attention for this shape"
        )
    group = mesh.get_group(axis_name)
    # scatter heads (split axis 2), gather the sequence (concat axis 1)
    q, k, v = (AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    if attention == "flash":
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = _dense_causal(q, k, v, causal, window)
    # the inverse: scatter the sequence, gather the heads
    out = AllToAll.apply(out, group, 1, 2)
    b, s = out.shape[:2]
    return out.reshape(b, s, hq * q.shape[3])
