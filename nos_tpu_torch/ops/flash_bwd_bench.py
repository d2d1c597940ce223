"""Time the flash-attention backward kernels (dQ and dK/dV) on the card
beside variants of them and SDPA's backward, at the Llama-3-8B attention
shapes (Hq 32, Hkv 8, hd 128, bf16) or, with ``--heads 8x1x256``,
Gemma-2B's (Hq 8, Hkv 1, hd 256).

    python3 -m nos_tpu_torch.ops.flash_bwd_bench \\
        [--variant NAME=PATH.cu ...] [--shapes 4x2048xc] [--heads HQxHKVxHD]

A variant is any CUDA source that exports the backward's C launchers
``nos_flash_bwd_dq`` and ``nos_flash_bwd_dkv`` with the signatures of
``csrc/flash_bwd.cu`` (an earlier version of the kernels, or one edited
for an experiment). It is built as ``flash_fwd_bench`` builds its
variants (the port's nvcc flags plus ``-I csrc``, into
``_build/variants/``, ptxas's report beside it).

A shape is ``BxS`` followed by ``xc`` (causal) or ``xn``. For each, one
JSON line: every implementation's dQ and dK/dV CUDA-event time per call
in turns (the list, then the list reversed), their device time from
torch.profiler, their TFLOP/s at the better event time (6 and 8 x hd
operations per visible pair), each kernel's bound, SDPA's backward (its
forward+backward minus its forward; a yardstick, never called by the
port), and each variant's largest difference from the package kernels'
dQ, dK and dV. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys

from nos_tpu_torch.ops.flash_fwd_bench import (
    HD, HKV, HQ, PEAK_BF16_FLOPS, build_variants, emit, parse_heads,
)

# operations per visible (query, key) pair per unit of head_dim
OPS_PER_PAIR = {"dq": 6, "dkv": 8}


def variant_calls(lib_path):
    """{"dq": call, "dkv": call} through a variant's launchers; a call
    takes (q, k, v, lse, do, delta, causal) and returns its gradients."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa

    dq_fn, dkv_fn = fa._bwd_symbols(ctypes.CDLL(str(lib_path)))

    def shape_args(q, k):
        b, sq, hq, hd = q.shape
        return (b, sq, k.shape[1], hq, k.shape[2], hd)

    def tail(causal, hd):
        return (0, 0, int(causal), 0, 1.0 / math.sqrt(hd), 0,
                torch.cuda.current_stream().cuda_stream)

    def dq_call(q, k, v, lse, do, delta, causal):
        dq = torch.empty_like(q)
        strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *do.stride()[:3],
                                           *dq.stride()[:3])
        err = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *shape_args(q, k),
                    strides, *tail(causal, q.shape[3]))
        if err:
            raise RuntimeError(f"variant dQ launch failed: cudaError {err}")
        return (dq,)

    def dkv_call(q, k, v, lse, do, delta, causal):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        strides = (ctypes.c_longlong * 18)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *do.stride()[:3],
                                           *dk.stride()[:3], *dv.stride()[:3])
        err = dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     *shape_args(q, k), strides, *tail(causal, q.shape[3]))
        if err:
            raise RuntimeError(f"variant dK/dV launch failed: cudaError {err}")
        return dk, dv

    return {"dq": dq_call, "dkv": dkv_call}


def time_shape(b, s, causal, variants, heads=(HQ, HKV, HD)) -> dict:
    import torch
    import torch.nn.functional as F

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.util.cuda_timing import device_ms, event_ms

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    hq, hkv, hd = heads
    q, k, v = randn(b, s, hq, hd), randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    do = randn(b, s, hq, hd)
    out, lse = fa.flash_attention_block(q, k, v, 0, 0, causal=causal)
    delta = fa.flash_delta(do, out)
    args = (q, k, v, lse, do, delta, 0, 0, causal, None, None)
    impls = {"kernel": {
        "dq": lambda: fa._flash_bwd_cuda(*args, True, False)[:1],
        "dkv": lambda: fa._flash_bwd_cuda(*args, False, True)[1:],
    }}
    for name, calls in variants.items():
        impls[name] = {kind: (lambda call=call: call(q, k, v, lse, do, delta, causal))
                       for kind, call in calls.items()}
    ref = {kind: [g.float() for g in impls["kernel"][kind]()] for kind in OPS_PER_PAIR}
    diff = {name: {kind: max(float((g.float() - r).abs().max())
                             for g, r in zip(impls[name][kind](), ref[kind]))
                   for kind in OPS_PER_PAIR}
            for name in variants}

    # SDPA's backward: [B, H, S, hd] copies made outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    fns = {f"{name}.{kind}": fn for name, calls in impls.items() for kind, fn in calls.items()}
    fns["sdpa.fwd"] = sdpa
    fns["sdpa.fwd_bwd"] = sdpa_fwd_bwd
    names = list(fns)
    times = {}
    for name in names + names[::-1]:
        times.setdefault(name, []).append(event_ms(fns[name]))
    best = {name: min(t) for name, t in times.items()}
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = {kind: ops * hd * pairs * b * hq for kind, ops in OPS_PER_PAIR.items()}
    return {
        "shape": [b, s, hq, hkv, hd], "causal": causal, "event_ms": times,
        "device_ms": {n: device_ms(fns[n]) for n in names},
        "tflops": {n: flops[n.split(".")[1]] / best[n] / 1e9 for n in names
                   if not n.startswith("sdpa.")},
        "bound_ms": {kind: f / PEAK_BF16_FLOPS * 1e3 for kind, f in flops.items()},
        "sdpa_backward_ms": best["sdpa.fwd_bwd"] - best["sdpa.fwd"],
        "max_abs_diff_vs_kernel": diff,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH.cu, a source exporting nos_flash_bwd_dq/_dkv")
    parser.add_argument("--shapes", default="4x2048xc")
    parser.add_argument("--heads", default=f"{HQ}x{HKV}x{HD}",
                        help="HQxHKVxHD of the timed shapes; 8x1x256 is Gemma-2B's")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    from nos_tpu_torch.ops import _build

    _build.build(["flash_fwd", "flash_bwd"])
    built = build_variants(args.variant)
    emit({"card": card, "kernel_ptxas": _build.ptxas_report("flash_bwd"),
          "variant_ptxas": {n: report for n, (_, report) in built.items()}})
    variants = {n: variant_calls(lib) for n, (lib, _) in built.items()}
    for spec in args.shapes.split(","):
        b, s, mode = spec.split("x")
        emit({**time_shape(int(b), int(s), mode == "c", variants,
                           parse_heads(args.heads)), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
