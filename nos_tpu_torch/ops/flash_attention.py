"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

Counterpart of ``nos_tpu/ops/flash_attention.py``. Public layout is the
reference's: q ``[B, Sq, Hq, hd]``, k/v ``[B, Skv, Hkv, hd]``; the kernels
read them through strides, so no transposed copies are made.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, built
by nvcc at first use, see ``_build.py``) or raises; a CPU tensor runs the
plain versions that repeat the kernels' arithmetic:
``flash_attention_reference`` (f32 scores and softmax statistics,
probabilities rounded to the value dtype before the PV product, O = 0 and
LSE = -inf for a row with no visible key) and
``flash_attention_bwd_reference`` (probabilities recomputed from the LSE,
p and dS rounded to q's dtype before their second products, f32 sums,
dK/dV summed over the GQA group in f32 and cast once).

``flash_attention`` is differentiable through ``_FlashAttention``, a
``torch.autograd.Function`` (the reference's ``custom_vjp``): it saves
(q, k, v, out, lse) and its backward runs the dQ and dK/dV kernels.
``flash_block_grads`` is the ring path's explicit per-block backward.

``LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count kernel launches
(never plain-version calls), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

# Kernel launches since import (or since a caller reset them to 0):
# forward, dQ and dK/dV.
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

# The forward kernel's tile: 128 query rows per block (64 per consumer
# warpgroup), 128 keys per K/V tile at head_dim 64 and 128, 64 at 256
# (``block_n``).
BLOCK_M = 128
BLOCK_N = 128
BLOCK_N_HD256 = 64
KERNEL_HEAD_DIMS = (64, 128, 256)


def validate_window(causal: bool, window) -> None:
    """Shared contract for windowed attention: a window silently ignored
    under causal=False, or a 0-width band NaN-ing the softmax, must be a
    loud error."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _block_needed(blk_q: int, blk_k: int, q_start, k_start, causal, window) -> bool:
    """Whether a (q block, k block) pair at these global starts can
    contribute any unmasked entry (the reference's ``_block_needed``).
    The kernels' tile walk and the ring's hop skip both follow it, so the
    ring never skips a block a kernel would have attended."""
    if not causal:
        return True
    needed = k_start <= q_start + blk_q - 1  # not wholly in the future
    if window is not None:
        needed = needed and k_start + blk_k - 1 >= q_start - window + 1
    return bool(needed)


def block_n(head_dim: int) -> int:
    """Keys per K/V tile of the forward kernel at ``head_dim``."""
    return BLOCK_N_HD256 if head_dim == 256 else BLOCK_N


def default_blocks(window: "int | None", head_dim: int = 128) -> "tuple[int, int]":
    """(blk_q, blk_k) of the Hopper forward kernel, with or without a
    window: 128 x 128 at head_dim 64 and 128, 128 x 64 at 256. Each of
    its two consumer warpgroups owns 64 query rows, the M of one wgmma,
    and keeps a 64 x blk_k f32 score tile and the 64 x hd output
    accumulator in registers (64 floats a thread each at hd 128; 32 and
    128 at hd 256); 128-key tiles fill the tensor cores' N. Q plus a
    three-stage K/V ring takes 224 KB of shared memory at hd 128, one
    block per SM; at hd 256 Q takes 64 KB and a 128-key stage 128 KB, so
    the tiles hold 64 keys and the ring two stages (192 KB). Windowed
    bands skip tiles outside the band at the same granularity."""
    return BLOCK_M, block_n(head_dim)


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, hd]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch "
            "or head_dim"
        )
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    kv_offset: int = 0,
    *,
    causal: bool = True,
    window: "int | None" = None,
    blk_k: "int | None" = None,
):
    """The plain version: online softmax over key tiles of ``blk_k``
    (default the kernel's own, ``block_n(hd)``, so the probabilities
    round to bf16 against the same running max), all query rows at once
    → (out ``[B, Sq, Hq, hd]`` in q's dtype, lse ``[B, Hq, Sq, 1]``
    f32)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    blk = blk_k or block_n(hd)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().reshape(b, sq, hkv, group, hd)
    qpos = int(q_offset) + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, group, sq), -math.inf, device=dev)
    l = torch.zeros((b, hkv, group, sq), device=dev)
    acc = torch.zeros((b, hkv, group, sq, hd), device=dev)
    for n0 in range(0, skv, blk):
        kt = k[:, n0:n0 + blk].float()
        vt = v[:, n0:n0 + blk]
        # bf16 products are exact in f32: f32 operands = bf16 operands
        # with f32 accumulation, the kernel's tensor-core mode
        s = torch.einsum("bsKgh,btKh->bKgst", qf, kt) * scale
        if causal:
            kpos = int(kv_offset) + torch.arange(n0, n0 + kt.shape[1], device=dev)
            visible = kpos[None, :] <= qpos[:, None]
            if window is not None:
                visible = visible & (qpos[:, None] - kpos[None, :] < window)
            s = s.masked_fill(~visible, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        m = m_new
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bKgst,btKh->bKgsh", p.to(v.dtype).float(), vt.float()
        )
    has_mass = l > 0.0
    safe_l = torch.where(has_mass, l, 1.0)
    out = torch.where(has_mass[..., None], acc / safe_l[..., None], 0.0)
    lse = torch.where(has_mass, m + torch.log(safe_l), -math.inf)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
    return out, lse.reshape(b, hq, sq, 1)


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors along head_dim: unit last stride,
    aligned base and (b, s, h) strides in multiples of 8 elements."""
    ok = (
        x.stride(-1) == 1
        and x.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st in x.stride()[:3])
    )
    return x if ok else x.contiguous()


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernels read q, k, v (and the backward's dO) through TMA
    tensor maps, which take the strides ``_kernel_ready`` allows except a
    0 stride on a dimension longer than 1 (an expanded tensor, such as a
    cotangent from autograd): that one is copied."""
    x = _kernel_ready(x)
    if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        x = x.contiguous()
    return x


def _stats_ready(x: torch.Tensor) -> torch.Tensor:
    """The dK/dV kernel reads lse and delta through 1-D TMA tensor maps:
    contiguous f32 with a 16-byte aligned base (a view at an odd offset
    is copied)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _typed(fn, argtypes):
    """Set a ctypes launcher's signature once. Every pointer and the
    stream are c_void_p (a bare int would be cut to 32 bits)."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _kernel_symbol():
    """The launcher of csrc/flash_fwd.cu, built and typed on first use."""
    from nos_tpu_torch.ops import _build

    return _typed(
        _build.load("flash_fwd").nos_flash_fwd_bf16,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [_STRIDES]
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )


def _bwd_symbols(lib=None):
    """The dQ and dK/dV launchers of csrc/flash_bwd.cu, or of ``lib``, a
    loaded library exporting the same two (``ops/flash_bwd_bench.py``'s
    variants)."""
    from nos_tpu_torch.ops import _build

    lib = lib or _build.load("flash_bwd")
    tail = [ctypes.c_int] * 6 + [_STRIDES] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return (
        _typed(lib.nos_flash_bwd_dq, [ctypes.c_void_p] * 7 + tail),
        _typed(lib.nos_flash_bwd_dkv, [ctypes.c_void_p] * 8 + tail),
    )


def _check_kernel_operands(hd: int, **tensors) -> None:
    """What the kernels take: bf16 operands, head_dim 64, 128 or 256,
    one device. Anything else raises; nothing falls back."""
    for name, x in tensors.items():
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA flash kernel takes bf16; {name} is {x.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernel is built for head_dim in {KERNEL_HEAD_DIMS}, "
            f"got {hd}"
        )
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"the flash kernel's operands lie on several devices: {devices}")


def _flash_fwd_cuda(q, k, v, q_offset, kv_offset, causal, window):
    global LAUNCHES
    hd = q.shape[3]
    _check_kernel_operands(hd, q=q, k=k, v=v)
    q, k, v = (_tma_ready(x) for x in (q, k, v))
    b, sq, hq, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = _kernel_symbol()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, skv, hq, hkv, hd, strides,
            int(q_offset), int(kv_offset), int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash forward kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, lse


def _check_tiles(blk_q, blk_k, head_dim: int = 128) -> None:
    """On the card the tiles are the kernel's own at this head_dim."""
    bn = block_n(head_dim)
    if blk_q not in (None, BLOCK_M) or blk_k not in (None, bn):
        raise ValueError(
            f"the CUDA kernel's tiles are fixed at {BLOCK_M}x{bn} at head_dim "
            f"{head_dim}; got blk_q={blk_q}, blk_k={blk_k}"
        )


def _forward(q, k, v, q_offset, kv_offset, causal, window, blk_q, blk_k):
    _check_inputs(q, k, v)
    validate_window(causal, window)
    if q.device.type == "cuda":
        _check_tiles(blk_q, blk_k, q.shape[3])
        return _flash_fwd_cuda(q, k, v, q_offset, kv_offset, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_offset, kv_offset, causal=causal, window=window,
            blk_k=blk_k,
        )
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


# ----------------------------------------------------------------- backward


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta_i = rowsum(dO_i * O_i) in f32: [B, S, H, hd] inputs →
    [B, H, S, 1] (the reference's ``_delta``)."""
    d = (do.float() * out.float()).sum(dim=-1)
    return d.transpose(1, 2).unsqueeze(-1).contiguous()


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    q_offset: int = 0,
    kv_offset: int = 0,
    *,
    causal: bool = True,
    window: "int | None" = None,
    grad_dtype=None,
    delta: "torch.Tensor | None" = None,
    blk_k: "int | None" = None,
):
    """The plain version of both backward kernels → (dq [B, Sq, Hq, hd],
    dk, dv [B, Skv, Hkv, hd]): the contribution of this K/V block, at
    these global offsets, given the full attention's ``out`` and ``lse``
    ([B, Hq, Sq, 1]). Mirrors ``_bwd_p_ds``: f32 scores, p = 0 where lse
    is -inf or the pair is masked, p and dS rounded to q's dtype before
    the dV / dK / dQ products, f32 sums (dK/dV over the GQA group too),
    one cast to ``grad_dtype`` (else q's / k's dtype) at the end. Key
    tiles of ``blk_k`` (default 256 keys) bound the memory of
    its f32 score tiles; they change no result."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    blk = blk_k or 256
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    if delta is None:
        delta = flash_delta(do, out)
    qf = q.float().reshape(b, sq, hkv, group, hd)
    dof = do.float().reshape(b, sq, hkv, group, hd)
    lse_g = lse.float().reshape(b, hkv, group, sq, 1)
    finite = torch.isfinite(lse_g)
    safe_lse = torch.where(finite, lse_g, 0.0)
    delta_g = delta.float().reshape(b, hkv, group, sq, 1)
    qpos = int(q_offset) + torch.arange(sq, device=dev)
    dq = torch.zeros((b, sq, hkv, group, hd), device=dev)
    dk = torch.empty((b, skv, hkv, hd), device=dev)
    dv = torch.empty((b, skv, hkv, hd), device=dev)
    for n0 in range(0, skv, blk):
        kt = k[:, n0:n0 + blk].float()
        vt = v[:, n0:n0 + blk].float()
        s = torch.einsum("bsKgh,btKh->bKgst", qf, kt) * scale
        p = torch.where(finite, torch.exp(s - safe_lse), 0.0)
        if causal:
            kpos = int(kv_offset) + torch.arange(n0, n0 + kt.shape[1], device=dev)
            visible = kpos[None, :] <= qpos[:, None]
            if window is not None:
                visible = visible & (qpos[:, None] - kpos[None, :] < window)
            p = torch.where(visible, p, 0.0)
        dp = torch.einsum("bsKgh,btKh->bKgst", dof, vt)
        ds = p * (dp - delta_g) * scale
        # the kernels' rounding points: bf16 operands of the second products
        p_r = p.to(q.dtype).float()
        ds_r = ds.to(q.dtype).float()
        dv[:, n0:n0 + blk] = torch.einsum("bKgst,bsKgh->btKh", p_r, dof)
        dk[:, n0:n0 + blk] = torch.einsum("bKgst,bsKgh->btKh", ds_r, qf)
        dq += torch.einsum("bKgst,btKh->bsKgh", ds_r, kt)
    return (
        dq.reshape(b, sq, hq, hd).to(grad_dtype or q.dtype),
        dk.to(grad_dtype or k.dtype),
        dv.to(grad_dtype or k.dtype),
    )


def _flash_bwd_cuda(q, k, v, lse, do, delta, q_offset, kv_offset, causal,
                    window, grad_dtype, need_dq=True, need_dkv=True):
    """Launch the dQ and/or dK/dV kernels; a gradient not asked for is
    returned as None and its kernel is not launched."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    hd = q.shape[3]
    _check_kernel_operands(hd, q=q, k=k, v=v, do=do)
    if lse.device != q.device or delta.device != q.device:
        raise ValueError("lse and delta must lie on q's device")
    if grad_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA flash backward writes bf16 or f32, not {grad_dtype}")
    if tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1], 1):
        raise ValueError(f"lse must be [B, Hq, Sq, 1], got {tuple(lse.shape)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be f32")
    if tuple(delta.shape) != tuple(lse.shape):
        raise ValueError(f"delta must be [B, Hq, Sq, 1], got {tuple(delta.shape)}")
    out_dtype = grad_dtype or torch.bfloat16
    out_f32 = int(out_dtype == torch.float32)
    q, k, v, do = (_tma_ready(x) for x in (q, k, v, do))
    lse, delta = _stats_ready(lse), _stats_ready(delta)
    b, sq, hq, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    args = (int(q_offset), int(kv_offset), int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(hd), out_f32)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    in_strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    dq_fn, dkv_fn = _bwd_symbols()
    dq = dk = dv = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if need_dq:
            dq = torch.empty((b, sq, hq, hd), dtype=out_dtype, device=q.device)
            strides = (ctypes.c_longlong * 15)(*in_strides, *dq.stride()[:3])
            err = dq_fn(*ins, dq.data_ptr(), b, sq, skv, hq, hkv, hd, strides,
                        *args, stream)
            if err != 0:
                raise RuntimeError(f"flash dQ kernel launch failed: cudaError {err}")
            DQ_LAUNCHES += 1
        if need_dkv:
            dk = torch.empty((b, skv, hkv, hd), dtype=out_dtype, device=q.device)
            dv = torch.empty_like(dk)
            strides = (ctypes.c_longlong * 18)(
                *in_strides, *dk.stride()[:3], *dv.stride()[:3]
            )
            err = dkv_fn(*ins, dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv,
                         hd, strides, *args, stream)
            if err != 0:
                raise RuntimeError(f"flash dK/dV kernel launch failed: cudaError {err}")
            DKV_LAUNCHES += 1
    return dq, dk, dv


def _backward(q, k, v, out, lse, do, q_offset, kv_offset, causal, window,
              blk_k=None, grad_dtype=None, delta=None, need_dq=True,
              need_dkv=True):
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(
            f"do {tuple(do.shape)} and out {tuple(out.shape)} must have q's "
            f"shape {tuple(q.shape)}"
        )
    if delta is None:
        delta = flash_delta(do, out)
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, lse, do, delta, q_offset, kv_offset,
                               causal, window, grad_dtype, need_dq, need_dkv)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, do, q_offset, kv_offset, causal=causal,
            window=window, grad_dtype=grad_dtype, delta=delta, blk_k=blk_k,
        )
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_flash``): the forward kernel,
    then a backward that recomputes the probabilities from the saved LSE
    in the dQ and dK/dV kernels. Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass, as ``jax.checkpoint`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, blk_q, blk_k):
        out, lse = _forward(q, k, v, 0, 0, causal, window, blk_q, blk_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.blk_k = causal, window, blk_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = _backward(
            q, k, v, out, lse, do, 0, 0, ctx.causal, ctx.window, ctx.blk_k,
            need_dq=need_q, need_dkv=need_k or need_v,
        )
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    blk_q: "int | None" = None,
    blk_k: "int | None" = None,
    window: "int | None" = None,
) -> torch.Tensor:
    """q [B, S, Hq, hd], k/v [B, S, Hkv, hd] → [B, S, Hq, hd].

    Hq must be a multiple of Hkv (GQA). Any S works: the kernel masks the
    ragged edge itself. ``window`` (requires causal): query i attends
    keys (i - window, i]; tiles outside the band are skipped.
    ``blk_q``/``blk_k`` set the plain version's key tiling on the CPU;
    on the card they must be None or the forward kernel's own
    (``default_blocks``: 128 x 128, or 128 x 64 at head_dim 256).
    Differentiable: the backward runs the dQ and dK/dV kernels."""
    return _FlashAttention.apply(q, k, v, causal, window, blk_q, blk_k)


def flash_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int,
    kv_offset: int,
    *,
    causal: bool = True,
    blk_q: "int | None" = None,
    blk_k: "int | None" = None,
    window: "int | None" = None,
):
    """Forward PARTIALS of q [B, Sq, Hq, hd] against one K/V block
    [B, Skv, Hkv, hd] whose global positions start at the given offsets
    → (out [B, Sq, Hq, hd], lse [B, Hq, Sq, 1] f32). Rows with no
    visible key in this block give out = 0 and lse = -inf, so partials
    merge exactly with ``merge_flash_partials``. Not differentiable on
    the card (as the reference's is not): the ring path takes its
    gradients from ``flash_block_grads``."""
    if q.device.type == "cuda" and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash_attention_block records no autograd graph on the card; "
            "take per-block gradients with flash_block_grads"
        )
    return _forward(q, k, v, q_offset, kv_offset, causal, window, blk_q, blk_k)


def flash_block_grads(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    q_offset: int,
    kv_offset: int,
    *,
    causal: bool = True,
    blk_q: "int | None" = None,
    blk_k: "int | None" = None,
    grad_dtype=None,
    delta: "torch.Tensor | None" = None,
    window: "int | None" = None,
):
    """Per-block gradients matching ``flash_attention_block``: the
    contribution of THIS K/V block to (dq [B, Sq, Hq, hd], dk, dv
    [B, Skv, Hkv, hd]), given the MERGED (out, lse) of the full
    attention. ``grad_dtype`` (f32 for the ring path, which sums the
    contributions across hops) overrides the input dtypes; ``delta``
    ([B, Hq, Sq, 1] f32) lets a caller precompute rowsum(do * out) once.
    On the card it runs the dQ and dK/dV kernels; on the CPU their
    plain version, over key tiles of ``blk_k``."""
    _check_inputs(q, k, v)
    validate_window(causal, window)
    if q.device.type == "cuda":
        _check_tiles(blk_q, blk_k, q.shape[3])
    return _backward(q, k, v, out, lse, do, q_offset, kv_offset, causal,
                     window, blk_k, grad_dtype, delta)


def merge_flash_partials(out_a, lse_a, out_b, lse_b):
    """Exact online-softmax merge of two block partials (out in
    [B, S, H, hd], lse in [B, H, S, 1]) → (out, lse) as if both blocks
    had been attended together."""
    lse_new = torch.logaddexp(lse_a, lse_b)  # -inf + -inf stays -inf
    neg_inf = torch.full_like(lse_new, -math.inf)
    w_a = torch.exp(torch.where(torch.isfinite(lse_a), lse_a - lse_new, neg_inf))
    w_b = torch.exp(torch.where(torch.isfinite(lse_b), lse_b - lse_new, neg_inf))
    w_a = w_a.transpose(1, 2)  # [B, H, S, 1] → [B, S, H, 1]
    w_b = w_b.transpose(1, 2)
    out = out_a.float() * w_a + out_b.float() * w_b
    return out.to(out_a.dtype), lse_new
