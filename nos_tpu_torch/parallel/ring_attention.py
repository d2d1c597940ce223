"""Ring attention: exact attention over a sequence sharded on ``sp``.

Counterpart of ``nos_tpu/parallel/ring_attention.py``. Each rank holds
its block of the sequence, ``[B, S/n, H, hd]`` at global positions
``r·S/n ...`` for sp index r, keeps its queries in place and passes
K/V blocks around the ring (``parallel/comm.py:ring_shift``, rank
r → r + 1). After i hops rank r holds block ``(r − i) mod n``. The
result is exact: every query sees the keys the causal (or windowed)
mask allows, wherever they live.

- ``ring_attention``: the plain ring, an f32 online-softmax accumulator
  (the reference's ``attention="dense"`` ring), differentiable by
  autograd through the shifts (``RingShift``).
- ``ring_flash_attention``: the flash kernels in block mode, a
  ``torch.autograd.Function``. Its forward runs ``flash_attention_block``
  per block at ``q_offset = r·S/n``, ``kv_offset = j·S/n`` and merges
  the f32 partials with ``merge_flash_partials``. Its backward replays a
  full revolution: ``flash_block_grads`` with f32 outputs and ``delta``
  computed once, dQ summed in place, dK and dV summed in f32 buffers
  that travel with their blocks and arrive home after n hops; each
  rounds once at the end.

A block the mask hides wholly (``_block_skippable``, the inverse of the
kernels' ``_block_needed``) skips its kernels but never its hop: the
ranks stay in lockstep. Under causal masking rank r runs r + 1 blocks.

Both take and return the rank's block: q/k/v ``[B, S/n, H, hd]`` in,
``[B, S/n, Hq·hd]`` out. Under tensor parallelism the heads are the
rank's own (``H/tp``; the model's column-parallel products made them)
and the ring math is unchanged: the ring runs within the rank's sp
line. The reference's ``batch_axis`` and ``head_axis`` arguments have
no counterpart: neither the batch nor the heads ever cross the ring.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from nos_tpu_torch.ops.flash_attention import (
    _block_needed,
    flash_attention_block,
    flash_block_grads,
    flash_delta,
    merge_flash_partials,
    validate_window,
)
from nos_tpu_torch.parallel.comm import RingShift, ring_shift
from nos_tpu_torch.parallel.mesh import axis_index, axis_size


def _block_skippable(kv_idx: int, my_idx: int, sq: int, skv: int, causal: bool,
                     window) -> bool:
    """Whether K/V block ``kv_idx`` is wholly masked for rank ``my_idx``'s
    queries: the inverse of ``_block_needed`` at the blocks' global
    starts, so a skip never disagrees with the kernels' coverage."""
    return not _block_needed(sq, skv, my_idx * sq, kv_idx * skv, causal, window)


def _online_block_update(q, k, v, m, l, acc, q_offset, kv_offset, causal, window=None):
    """Fold one K/V block into the accumulators. q ``[B, Sq, Kv, g, hd]``
    grouped queries, k/v ``[B, Skv, Kv, hd]``; f32 accumulators m, l
    ``[B, Kv, g, Sq]`` and acc ``[B, Kv, g, Sq, hd]``. Scores in f32 from
    the input-dtype operands; probabilities rounded to v's dtype before
    the PV product, as the reference rounds them."""
    hd = q.shape[-1]
    scores = torch.einsum("bsKgh,btKh->bKgst", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(sq, device=q.device)
        kv_pos = kv_offset + torch.arange(skv, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        scores = scores.masked_fill(~mask, -math.inf)
    new_m = torch.maximum(m, scores.amax(dim=-1))
    # rows masked so far keep new_m = -inf: exp against 0, never NaN
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    probs = torch.exp(scores - safe_m[..., None])
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    new_l = l * correction + probs.sum(dim=-1)
    new_acc = acc * correction[..., None] + torch.einsum(
        "bKgst,btKh->bKgsh", probs.to(v.dtype).float(), v.float()
    )
    return new_m, new_l, new_acc


def _sp_axis(mesh, axis_name: str):
    """(group, n, rank) of the sequence axis; raises for a missing axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no sequence axis {axis_name!r}")
    return (mesh.get_group(axis_name), axis_size(mesh, axis_name),
            axis_index(mesh, axis_name))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention of this rank's q/k/v blocks ``[B, S/n, H, hd]``
    over the sequence sharded on ``axis_name``, by the plain ring →
    ``[B, S/n, Hq·hd]`` in q's dtype. The ring runs within the rank's
    line along ``axis_name``; a batch split over ``dp`` never crosses it."""
    validate_window(causal, window)
    group, n, my_idx = _sp_axis(mesh, axis_name)
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    shape = (b, hkv, hq // hkv, sq)
    m = torch.full(shape, -math.inf, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(shape + (hd,), device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        if i:
            k_blk, v_blk = RingShift.apply(group, 1, k_blk, v_blk)
        kv_idx = (my_idx - i) % n
        if not _block_skippable(kv_idx, my_idx, sq, k.shape[1], causal, window):
            m, l, acc = _online_block_update(
                qg, k_blk, v_blk, m, l, acc, my_idx * sq, kv_idx * k.shape[1],
                causal, window,
            )
        else:
            # A skipped block still joins the graph, with a zero gradient:
            # autograd runs a shift's backward only where its output is
            # used, and every rank must run the same reverse shifts.
            acc = acc + 0.0 * (k_blk.sum() + v_blk.sum()).float()
    out = acc / l[..., None]  # a causal row always sees its own position
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq * hd).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The reference's ``make_ring_flash_local`` custom_vjp: the forward
    ring of block kernels, and a backward that replays the ring. Runs
    with grad mode off inside, so ``flash_attention_block`` records no
    graph (on the card it raises if asked to)."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, my_idx, causal, window):
        sq = q.shape[1]
        q_off = my_idx * sq

        def block(k_blk, v_blk, kv_idx):
            return flash_attention_block(q, k_blk, v_blk, q_off, kv_idx * sq,
                                         causal=causal, window=window)

        out, lse = block(k, v, my_idx)
        # f32 across the ring, one rounding at the end
        out = out.float()
        k_blk, v_blk = k, v
        for i in range(1, n):
            k_blk, v_blk = ring_shift([k_blk, v_blk], group)
            kv_idx = (my_idx - i) % n
            if not _block_skippable(kv_idx, my_idx, sq, sq, causal, window):
                out, lse = merge_flash_partials(out, lse, *block(k_blk, v_blk, kv_idx))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, my_idx, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, my_idx, causal, window = ctx.ring
        sq = q.shape[1]
        q_off = my_idx * sq
        do = do.contiguous()
        delta = flash_delta(do, out)  # loop-invariant: once, not per hop
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_blk, v_blk = k, v
        for i in range(n):
            kv_idx = (my_idx - i) % n
            if not _block_skippable(kv_idx, my_idx, sq, sq, causal, window):
                dq_c, dk_c, dv_c = flash_block_grads(
                    q, k_blk, v_blk, out, lse, do, q_off, kv_idx * sq,
                    causal=causal, window=window, grad_dtype=torch.float32,
                    delta=delta,
                )
                dq += dq_c
                dk += dk_c
                dv += dv_c
            # the accumulators travel with their blocks; after the last
            # hop only they are still needed, and they are home
            if i < n - 1:
                k_blk, v_blk, dk, dv = ring_shift([k_blk, v_blk, dk, dv], group)
            else:
                dk, dv = ring_shift([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``ring_attention`` through the flash kernels in block mode (their
    plain versions on CPU tensors): this rank's q/k/v blocks
    ``[B, S/n, H, hd]`` → ``[B, S/n, Hq·hd]``, differentiable. Every
    rank's block has the same length."""
    validate_window(causal, window)
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"q block {q.shape[1]} and K/V block {k.shape[1]} differ in length"
        )
    group, n, my_idx = _sp_axis(mesh, axis_name)
    out = _RingFlash.apply(q, k, v, group, n, my_idx, causal, window)
    b, s, hq, hd = q.shape
    return out.reshape(b, s, hq * hd)
