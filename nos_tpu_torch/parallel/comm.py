"""The collectives of the multi-device paths, written out.

Counterpart of the ``lax.ppermute``, ``lax.all_to_all`` and ``psum``
calls in the reference's shard_map bodies (``parallel/ring_attention.py``,
``parallel/ulysses.py``) and of the collectives XLA inserts from its
NamedShardings (``parallel/sharding.py``: the gradient sums over ``dp``,
the tensor-parallel all-reduces, FSDP's all-gather on use and
reduce-scatter of the gradient):

- ``ring_shift``: every rank of a group sends to rank + step and
  receives from rank - step (``batch_isend_irecv``); several tensors
  travel as one message;
- ``all_to_all``: the tiled all-to-all on a ``[B, S, H, hd]`` tensor,
  chunk j of ``split_axis`` going to rank j and the chunks received
  concatenated along ``concat_axis`` in rank order;
- ``all_reduce``: a sum or mean over one or more groups; ``all_reduce_max``;
- ``all_gather`` / ``reduce_scatter``: along one dim of a tensor, rank
  order along the group;
- ``broadcast``: one group rank's tensor to every rank of the group
  (the pipeline's hand-off of the last stage's activations).

The group's backend picks the transport (``dist.get_backend``): NCCL
moves device tensors; gloo moves host tensors, so a device tensor goes
through pinned host memory and back (``transport`` names which). Ranks
that share one card (NCCL refuses two ranks on one device) run over
gloo that way; the kernels still run on the card. Sums of bf16 / f16
run in f32 and round once, on either backend. Under gloo a
reduce-scatter is an all-reduce followed by the rank's slice (gloo's
own reduce-scatter is not in every torch release), so it moves twice
the bytes of NCCL's.

The autograd Functions: ``RingShift`` and ``AllToAll`` (backward: the
inverse exchange), and the pieces of Megatron-style tensor parallelism
and FSDP:

- ``copy_to_group``: identity forward, all-reduce backward, before a
  column-parallel product;
- ``reduce_from_group``: all-reduce forward, identity backward, after a
  row-parallel product;
- ``gather_from_group``: all-gather forward, the rank's slice backward;
- ``fsdp_gather``: all-gather of a weight shard on use, reduce-scatter
  of its gradient.

``timed_collectives`` records the host wall time of every collective
by kind (the card synchronized around each) while it is active.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# Message segments start on 16-byte boundaries, so every unpacked view
# is aligned for its dtype.
_ALIGN = 16


# kind -> host wall ms of each collective, while timed_collectives is on
_TIMES: Optional[Dict[str, List[float]]] = None


@contextlib.contextmanager
def timed_collectives():
    """Within the block, every collective's host wall time (the card
    synchronized before and after it, so the time is the collective's
    alone) is appended to the yielded dict under its kind: "tp" (the
    tensor-parallel all-reduces and gathers), "fsdp_gather",
    "fsdp_reduce_scatter", "grad_sum" (the trainer's sum over the mesh),
    "ring" (shifts and all-to-alls), "ep" (the expert-parallel gather and
    the global routing counts and aux sums), "pp" (the pipeline's hops
    and its loss scalar), "pp_broadcast" (its last stage's activations)
    and "other". Costs two card syncs a collective while on; nothing when
    off."""
    global _TIMES
    outer, _TIMES = _TIMES, {}
    try:
        yield _TIMES
    finally:
        _TIMES = outer


@contextlib.contextmanager
def _clock(kind: str):
    if _TIMES is None:
        yield
        return
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        _TIMES.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)


def transport(group, device) -> str:
    """How tensors on ``device`` cross ``group``: "nccl", "gloo" (host
    tensors) or "gloo-host-staged" (device tensors through pinned host
    memory; a reduce-scatter is an all-reduce and a slice)."""
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


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1,
               kind: str = "ring") -> List[torch.Tensor]:
    """Send ``tensors`` to group rank (r + step) mod n and return what
    rank (r - step) mod n sent, same shapes and dtypes, on the same
    device. One message a call; a group of one returns its input."""
    n = dist.get_world_size(group)
    tensors = list(tensors)
    if n == 1:
        return tensors
    r = dist.get_rank(group)
    dev = tensors[0].device
    with _clock(kind):
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
    with _clock("ring"):
        wire = _to_wire(send, group)
        recv = _empty_wire(wire)
        dist.all_to_all_single(recv, wire, group=group)
        return torch.cat(recv.to(x.device).unbind(0), dim=concat_axis)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` to sum in: f32 for the 16-bit floats, else x's
    dtype."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.clone()


def all_reduce(x: torch.Tensor, groups: Sequence, mean: bool = False,
               kind: str = "other") -> torch.Tensor:
    """Sum (or mean) of ``x`` over every rank of ``groups`` (the groups of
    a mesh's axes: reducing over each in turn reduces over the mesh).
    Returns a new tensor in x's dtype (16-bit floats sum in f32 and round
    once); ``x`` is left as it was."""
    out = _wide(x)
    count = 1
    with _clock(kind):
        for group in groups:
            wire = _to_wire(out, group)
            dist.all_reduce(wire, group=group)
            if wire is not out:
                out.copy_(wire)
            count *= dist.get_world_size(group)
    out = out / count if mean else out
    return out.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """Elementwise max of ``x`` over ``group``, a new tensor."""
    out = x.clone()
    with _clock(kind):
        wire = _to_wire(out, group)
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)
        if wire is not out:
            out.copy_(wire)
    return out


def all_gather(x: torch.Tensor, group, dim: int, kind: str = "other") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group rank order.
    The bytes travel as they are (any dtype, every rank's ``x`` of one
    shape), so the result is bit-exact."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    with _clock(kind):
        wire = _to_wire(raw, group)
        parts = [_empty_wire(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        parts = [p.to(x.device).view(x.dtype).view(x.shape) for p in parts]
        return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, group, src: int, kind: str = "other") -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (the others'
    ``x`` give only the shape and dtype), bit-exact, a new tensor."""
    if dist.get_world_size(group) == 1:
        return x
    with _clock(kind):
        wire = _to_wire(x.contiguous(), group)
        if wire is x:
            wire = x.clone()
        dist.broadcast(wire, dist.get_global_rank(group, src), group=group)
        return wire.to(x.device)


def reduce_scatter(x: torch.Tensor, group, dim: int, kind: str = "other") -> torch.Tensor:
    """The sum of the ranks' ``x`` (one shape on every rank), and of it
    this rank's chunk along ``dim`` (chunk r for group rank r), in x's
    dtype; 16-bit floats sum in f32 and round once. NCCL reduce-scatters;
    gloo all-reduces and slices."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over {n} ranks")
    r = dist.get_rank(group)
    if dist.get_backend(group) != "nccl":
        total = all_reduce(x, [group], kind=kind)
        return total.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n).contiguous()
    send = torch.stack([c.float() if x.dtype in (torch.bfloat16, torch.float16) else c
                        for c in x.chunk(n, dim=dim)]).contiguous()
    out = torch.empty(send.shape[1:], dtype=send.dtype, device=x.device)
    with _clock(kind):
        dist.reduce_scatter_tensor(out, send, group=group)
    return out.to(x.dtype)


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


class StageShift(torch.autograd.Function):
    """One pipeline hop: ``x`` to the next stage of ``group`` (rank + 1),
    the previous stage's in return; the backward sends the gradient back
    one stage. Timed as "pp"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift([x], group, 1, kind="pp")[0]

    @staticmethod
    def backward(ctx, grad):
        return ring_shift([grad], ctx.group, -1, kind="pp")[0], None


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


class CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over ``group``
    backward: the input of a column-parallel product, whose ranks each
    give a part of its gradient."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, [ctx.group], kind=ctx.kind), None, None


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a
    row-parallel product, each rank holding a partial sum."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce(x, [group], kind=kind)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward, the rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group, dim, kind=kind)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


class FsdpGather(torch.autograd.Function):
    """FSDP's weight on use: the shards all-gathered along ``dim``
    forward; the gradient reduce-scattered back to the shards (the sum
    over the group's ranks, each keeping its own chunk) backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim, kind="fsdp_gather")

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim, kind="fsdp_reduce_scatter"), None, None


def copy_to_group(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """``CopyToGroup`` over ``group``; ``x`` itself for no group. ``kind``
    names the timing bucket of its collective (``timed_collectives``)."""
    return x if group is None else CopyToGroup.apply(x, group, kind)


def reduce_from_group(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """``ReduceFromGroup`` over ``group``; ``x`` itself for no group."""
    return x if group is None else ReduceFromGroup.apply(x, group, kind)


def gather_from_group(x: torch.Tensor, group, dim: int = -1, kind: str = "tp") -> torch.Tensor:
    """``GatherFromGroup`` over ``group``; ``x`` itself for no group."""
    return x if group is None else GatherFromGroup.apply(x, group, dim % x.dim(), kind)


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``FsdpGather`` over ``group``; ``x`` itself for no group."""
    return x if group is None else FsdpGather.apply(x, group, dim)
