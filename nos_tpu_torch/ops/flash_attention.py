"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``nos_tpu/ops/flash_attention.py`` (forward only: the two
backward kernels are the training slice, still to port). Public layout is
the reference's: q ``[B, Sq, Hq, hd]``, k/v ``[B, Skv, Hkv, hd]``; the
kernel reads them through strides, so no transposed copies are made.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches ``csrc/flash_fwd.cu`` (built by nvcc at first use, see
``_build.py``) or raises; a CPU tensor runs ``flash_attention_reference``,
the plain version that repeats the kernel's arithmetic (f32 scores and
softmax statistics, probabilities rounded to the value dtype before the
PV product, O = 0 and LSE = -inf for a row with no visible key).

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

# The CUDA kernel's tile: 64 query rows per block, 64 keys per K/V tile.
BLOCK_M = 64
BLOCK_N = 64
KERNEL_HEAD_DIMS = (64, 128)


def validate_window(causal: bool, window) -> None:
    """Shared contract for windowed attention: a window silently ignored
    under causal=False, or a 0-width band NaN-ing the softmax, must be a
    loud error."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def default_blocks(window: "int | None") -> "tuple[int, int]":
    """(blk_q, blk_k) of the Hopper kernel: 64 x 64 with or without a
    window. Sixteen query rows per warp keeps the f32 accumulator of a
    128-wide head in registers (64 floats a thread), and 64-key tiles
    keep Q plus one K and one V tile inside 52 KB of shared memory, so
    several blocks share an SM. Windowed bands skip tiles outside the
    band at the same granularity."""
    return BLOCK_M, BLOCK_N


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
    (default the kernel's 64), all query rows at once → (out
    ``[B, Sq, Hq, hd]`` in q's dtype, lse ``[B, Hq, Sq, 1]`` f32)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    blk = blk_k or BLOCK_N
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


def _kernel_symbol():
    """The launcher of csrc/flash_fwd.cu, built and typed on first use.
    Every pointer and the stream are c_void_p (a bare int would be cut
    to 32 bits)."""
    from nos_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").nos_flash_fwd_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong)
        ] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def _flash_fwd_cuda(q, k, v, q_offset, kv_offset, causal, window):
    global LAUNCHES
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA flash kernel takes bf16; {name} is {x.dtype}")
    hd = q.shape[3]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernel is built for head_dim in {KERNEL_HEAD_DIMS}, "
            f"got {hd}"
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward kernels are not ported yet "
            "(ROADMAP Queue 1 item 6: training slice)"
        )
    q, k, v = (_kernel_ready(x) for x in (q, k, v))
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


def _forward(q, k, v, q_offset, kv_offset, causal, window, blk_q, blk_k):
    _check_inputs(q, k, v)
    validate_window(causal, window)
    if q.device.type == "cuda":
        if blk_q not in (None, BLOCK_M) or blk_k not in (None, BLOCK_N):
            raise ValueError(
                f"the CUDA kernel's tiles are fixed at {BLOCK_M}x{BLOCK_N}; "
                f"got blk_q={blk_q}, blk_k={blk_k}"
            )
        return _flash_fwd_cuda(q, k, v, q_offset, kv_offset, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_offset, kv_offset, causal=causal, window=window,
            blk_k=blk_k,
        )
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


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
    on the card they must be None or the kernel's own 64 x 64."""
    return _forward(q, k, v, 0, 0, causal, window, blk_q, blk_k)[0]


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
    merge exactly with ``merge_flash_partials``."""
    return _forward(q, k, v, q_offset, kv_offset, causal, window, blk_q, blk_k)


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
