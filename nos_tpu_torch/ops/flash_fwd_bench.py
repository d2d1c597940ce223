"""Time the flash-attention forward kernel on the card beside variants of
it and SDPA, at the Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128,
bf16) or, with ``--heads 8x1x256``, Gemma-2B's (Hq 8, Hkv 1, hd 256).

    python3 -m nos_tpu_torch.ops.flash_fwd_bench \\
        [--variant NAME=PATH.cu ...] [--shapes 4x2048xc,2x512xc] [--host]
        [--heads HQxHKVxHD]

A variant is any CUDA source that exports the forward's C launcher
``nos_flash_fwd_bf16`` with the signature of ``csrc/flash_fwd.cu`` (an
earlier version of the kernel, or one edited for an experiment). It is
built with the port's nvcc flags plus ``-I csrc`` (so it may include
``sm90.cuh``) into ``_build/variants/``, with ptxas's report beside it.

A shape is ``BxS`` followed by ``xc`` (causal) or ``xn``. For each, one
JSON line: every implementation's CUDA-event time per call in turns
(the list, then the list reversed), its device time from torch.profiler
(the two differ where the host is slower than the card), its TFLOP/s at
the better event time, the bound, and each variant's largest difference
from the package kernel's O. ``--host`` adds the host microseconds per
call of each layer of the package's call path at [2, 512]. SDPA is a
yardstick; the port never calls it. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time

HQ, HKV, HD = 32, 8, 128
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants(specs):
    """name -> (library path, ptxas report), all nvcc runs started together."""
    from nos_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        name, src = spec.split("=", 1)
        lib = out_dir / f"lib{name}.so"
        with open(lib.with_suffix(".log"), "w") as log:
            procs[name] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                 str(_build.CSRC), "-o", str(lib), src],
                stdout=log, stderr=subprocess.STDOUT))
    built = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {name}: see {lib.with_suffix('.log')}")
        built[name] = (lib, _build.parse_ptxas_log(lib.with_suffix(".log").read_text()))
    return built


def launcher(lib_path):
    """A call(q, k, v, causal) -> (out, lse) through a variant's launcher."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa

    fn = ctypes.CDLL(str(lib_path)).nos_flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [fa._STRIDES]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])

    def call(q, k, v, causal):
        b, sq, hq, hd = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *out.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], hd, strides, 0, 0,
                 int(causal), 0, 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: cudaError {err}")
        return out, lse

    return call


def parse_heads(spec: str):
    """``HQxHKVxHD`` -> (Hq, Hkv, head_dim)."""
    hq, hkv, hd = (int(x) for x in spec.split("x"))
    return hq, hkv, hd


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
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {"kernel": lambda: fa.flash_attention_block(q, k, v, 0, 0, causal=causal)}
    for name, call in variants.items():
        fns[name] = lambda call=call: call(q, k, v, causal)
    fns["sdpa"] = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    ref = fns["kernel"]()[0].float()
    diff = {n: float((fns[n]()[0].float() - ref).abs().max()) for n in variants}
    names = list(fns)
    times = {}
    for name in names + names[::-1]:
        times.setdefault(name, []).append(event_ms(fns[name]))
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * hd * pairs * b * hq
    return {"shape": [b, s, hq, hkv, hd], "causal": causal, "event_ms": times,
            "device_ms": {n: device_ms(fns[n]) for n in names},
            "tflops": {n: flops / min(t) / 1e9 for n, t in times.items()},
            "bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "max_abs_diff_vs_kernel": diff}


def host_breakdown() -> dict:
    """Host microseconds per call of each layer of the call path at [2, 512]."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa

    b, s = 2, 512
    q = torch.zeros((b, s, HQ, HD), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((b, s, HKV, HD), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros_like(k)
    out, lse = torch.empty_like(q), torch.empty((b, HQ, s, 1), device="cuda")
    fn = fa._kernel_symbol()
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, s, HQ, HKV, HD, strides, 0, 0, 1, 0, 1.0 / math.sqrt(HD),
            torch.cuda.current_stream().cuda_stream)
    layers = {
        "c_launcher": lambda: fn(*args),
        "two_empty_outputs": lambda: (torch.empty_like(q), torch.empty_like(lse)),
        "operand_checks": lambda: (fa._check_inputs(q, k, v),
                                   fa._check_kernel_operands(HD, q=q, k=k, v=v)),
        "tma_ready_x3": lambda: [fa._tma_ready(x) for x in (q, k, v)],
        "current_stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
        "flash_fwd_cuda": lambda: fa._flash_fwd_cuda(q, k, v, 0, 0, True, None),
        "flash_attention_block": lambda: fa.flash_attention_block(q, k, v, 0, 0),
    }
    result = {}
    for name, layer in layers.items():
        for _ in range(20):
            layer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            layer()
        result[name] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH.cu, a source exporting nos_flash_fwd_bf16")
    parser.add_argument("--shapes", default="4x2048xc,2x512xc")
    parser.add_argument("--host", action="store_true")
    parser.add_argument("--heads", default=f"{HQ}x{HKV}x{HD}",
                        help="HQxHKVxHD of the timed shapes; 8x1x256 is Gemma-2B's")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    from nos_tpu_torch.ops import _build

    _build.build(["flash_fwd"])
    built = build_variants(args.variant)
    emit({"card": card, "kernel_ptxas": _build.ptxas_report("flash_fwd"),
          "variant_ptxas": {n: report for n, (_, report) in built.items()}})
    variants = {n: launcher(lib) for n, (lib, _) in built.items()}
    for spec in args.shapes.split(","):
        b, s, mode = spec.split("x")
        emit({**time_shape(int(b), int(s), mode == "c", variants,
                           parse_heads(args.heads)), "card": card})
    if args.host:
        emit({"host_us_per_call": host_breakdown(), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
