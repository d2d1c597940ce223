"""The collectives of the sequence- and data-parallel paths.

Counterpart of the ``lax.ppermute``, ``lax.all_to_all`` and ``psum``
calls in the reference's shard_map bodies (``parallel/ring_attention.py``,
``parallel/ulysses.py``, the gradient sums XLA inserts for ``dp``):

- ``ring_shift``: every rank of a group sends to rank + step and
  receives from rank - step (``batch_isend_irecv``); several tensors
  travel as one message;
- ``all_to_all``: the tiled all-to-all on a ``[B, S, H, hd]`` tensor,
  chunk j of ``split_axis`` going to rank j and the chunks received
  concatenated along ``concat_axis`` in rank order;
- ``all_reduce``: a sum or mean over one or more groups.

The group's backend picks the transport (``dist.get_backend``): NCCL
moves device tensors; gloo moves host tensors, so a device tensor goes
through pinned host memory and back (``transport`` names which). Ranks
that share one card (NCCL refuses two ranks on one device) run over
gloo that way; the kernels still run on the card.

``RingShift`` and ``AllToAll`` are autograd Functions whose backward is
the inverse exchange, for the paths whose gradients autograd takes.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

# Message segments start on 16-byte boundaries, so every unpacked view
# is aligned for its dtype.
_ALIGN = 16


def transport(group, device) -> str:
    """How tensors on ``device`` cross ``group``: "nccl", "gloo" (host
    tensors) or "gloo-host-staged" (device tensors through pinned host
    memory)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl"
    if backend == "gloo":
        return "gloo" if torch.device(device).type == "cpu" else "gloo-host-staged"
    raise ValueError(f"no transport for process group backend {backend!r}")


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: itself, or a pinned host
    copy for gloo."""
    if transport(group, x.device) == "gloo-host-staged":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x


def _empty_wire(wire: torch.Tensor) -> torch.Tensor:
    """A receive buffer like ``wire``, pinned where ``wire`` is, so the
    copy back to the card is a DMA from page-locked memory. Pinned blocks
    come from PyTorch's caching host allocator and are reused across
    calls."""
    return torch.empty(wire.shape, dtype=wire.dtype, device=wire.device,
                       pin_memory=wire.is_pinned())


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One byte buffer holding every tensor, each segment padded to
    ``_ALIGN`` bytes."""
    parts = []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % _ALIGN
        parts.append(raw)
        if pad:
            parts.append(raw.new_zeros(pad))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).view(t.shape))
        at += n + (-n % _ALIGN)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1) -> List[torch.Tensor]:
    """Send ``tensors`` to group rank (r + step) mod n and return what
    rank (r - step) mod n sent, same shapes and dtypes, on the same
    device. One message a call; a group of one returns its input."""
    n = dist.get_world_size(group)
    tensors = list(tensors)
    if n == 1:
        return tensors
    r = dist.get_rank(group)
    dev = tensors[0].device
    send = _to_wire(_pack(tensors), group)
    recv = _empty_wire(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, (r + step) % n), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (r - step) % n), group),
    ])
    for work in works:
        work.wait()
    return _unpack(recv.to(dev), tensors)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(..., tiled=True)``): split
    ``x`` into n chunks along ``split_axis``, send chunk j to rank j, and
    concatenate the chunks received along ``concat_axis``, rank 0's
    first."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(
            f"axis {split_axis} of {tuple(x.shape)} does not split over {n} ranks"
        )
    # stack keeps a permuted input's memory format; the wire needs rows
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    wire = _to_wire(send, group)
    recv = _empty_wire(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_axis)


def all_reduce(x: torch.Tensor, groups: Sequence, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) of ``x`` over every rank of ``groups`` (the groups of
    a mesh's axes: reducing over each in turn reduces over the mesh).
    Returns a new tensor; ``x`` is left as it was."""
    out = x.clone()
    count = 1
    for group in groups:
        wire = _to_wire(out, group)
        dist.all_reduce(wire, group=group)
        if wire is not out:
            out.copy_(wire)
        count *= dist.get_world_size(group)
    return out / count if mean else out


class RingShift(torch.autograd.Function):
    """``ring_shift`` with the reverse shift as its backward (the
    transpose of a ppermute)."""

    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        return tuple(ring_shift(tensors, group, step))

    @staticmethod
    def backward(ctx, *grads):
        # autograd materializes unused outputs' gradients as zeros, so
        # every rank sends the same shapes
        return (None, None, *ring_shift(grads, ctx.group, -ctx.step))


class AllToAll(torch.autograd.Function):
    """``all_to_all`` with the inverse exchange as its backward."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return all_to_all(grad, ctx.group, concat_axis, split_axis), None, None, None
