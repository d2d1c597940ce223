#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0):

1. build: every CUDA kernel of the port, compiled by nvcc from the
   checkout's sources, all at once (nos_tpu_torch/ops/_build.py);
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128,
   bf16), with CUDA-event times of the kernel, the plain version, one
   PyTorch library call (SDPA, a yardstick the port never calls) and the
   card's bound for the same work, the kernel's and SDPA's device time
   from torch.profiler (CUDA events around one call measure the host
   where it is the slower side, as at [2, 512]), plus untimed cases at
   the forward kernel's 128 x 128 tile edges (S 127 / 129 / 255, a
   window with offsets off the tile grid, Skv 1, hd 64, q as a
   transposed view, no GQA); the summary line carries each kernel's
   time and TFLOP/s at the training shape, ptxas's registers and spills
   of every instantiation and the build seconds. kernel_bwd: the dQ and
   dK/dV kernels against their plain version at the sixteen cases of
   tests/test_torch_cuda.py (among them the edges of their 64-row and
   128-key tiles, offsets off the tile grid with a window, hd 64, no
   GQA, Skv 1) and at the training shape (B 4, S 2048, causal), where
   each is timed beside its bound, the plain version and SDPA's
   backward (its forward+backward minus its forward). Then the three
   kernels at head_dim 256 (Gemma-2B's Hq 8, Hkv 1) against their plain
   versions at the edges of their tiles (S 63 / 64 / 65 / 127 / 129),
   Skv 1, offsets off the grid with a window, MQA and GQA, q as a
   transposed view and f32 gradient outputs, and timed at the prefill
   shape [2, 512] and the training shape [4, 2048];
3. model: Llama-3-8B at full width (random weights from a seed),
   attention="flash": llama_forward flash against dense on [1, 1024],
   generate() greedy on [2, 512] prompts (the kernel's launch count is
   zeroed just before and read just after: one launch per layer), one
   decode step's time beside the weight-read bound with a torch.profiler
   pass over eight steps (device-busy time, idle share, launches, top
   kernels), and a tiny config on the card against the same config on
   the CPU;
4. engine: the continuous-batching Engine serving six requests (padded
   and chunked admission, a shared-prefix cache hit), 32 tokens each;
5. train_grads: full width, 2 layers, [1, 1024]: llama_loss gradients
   through the kernels (flash) against autograd of the einsums (dense);
6. train: the trainer's main path, Llama-3-8B at full width and depth,
   flash + remat, bf16, built-in momentum SGD, batches of [4, 2048] from
   BatchLoader through prefetch_to_device: one warm-up and three timed
   steps, launches counted per step (forward 64 with the recompute, dQ
   32, dK/dV 32), step time, tokens/s, MFU, peak memory;
7. train_adamw: 4 layers at full width, the AdamW factory with
   accum_steps=2, two steps.

The serving extensions (after the engine phase, before training):

8. quantize: the full-width Llama-3-8B to int8 and to int4 (group 128)
   on the card: weight bytes, conversion seconds, peak memory; at 2
   layers, llama_forward on [1, 1024] with flash against the fake-quant
   oracle (dequantize_params, then the bf16 forward): max abs error,
   relative Frobenius error (limits 3e-2 int8, 5e-2 int4), top-1
   agreement;
9. generate_quant: full depth, generate() greedy on [2, 512] + 32 over
   int8 weights, int8 + kv_quant, int4 + kv_quant (forward launches
   zeroed before each and 32 after);
10. decode_quant: one decode step at batch 2, cache 544, for bf16 /
    int8 / int4 weights with kv_quant off and on, beside each format's
    weight-read bound; torch.profiler passes over the int8 and int4
    steps; KV bytes and one step at batch 4, max_len 4096, bf16 against
    int8 cache;
11. engine_quant_lora: the engine workload over int8 weights with
    kv_quant; a multi-LoRA Engine (two rank-8 adapters on wq / wv,
    seeded non-zero b) whose adapter-0 request must equal the bare
    base's tokens, token for token, in the same batch;
12. spec_engine: SpecEngine over the full-depth target and a 2-layer
    draft sharing its embedding and lm_head, and with the target as
    its own draft, k = 4, 4 requests x 32 tokens: rounds, mean accepted,
    tokens/s, agreement with the base Engine;

the MoE phases (after the serving extensions, once the Llama trees are
freed), on Mixtral-8x7B's shape with random weights from seeds:

13. moe_check: moe_mlp at full width (bf16, [1, 1024] hidden states,
    two layers of experts) at capacity factor 8 against a dense
    per-token oracle (relative Frobenius error <= 2e-2), the pairs
    dropped at the default factor 1.25, a zero router's ties picking
    experts [0, 1] on the card, a tiny f32 MoE on the card against the
    CPU (identical routing, outputs within 1e-5);
14. moe_train_grads: 2 layers at full width, [1, 1024]: llama_loss
    gradients (router, expert stacks, attention, embeddings, the aux
    term) flash against dense under the train_grads limits, launches
    2 / 2 / 2, held with tied (zero) routers; a random router's run is
    reported beside it (near-tied tokens can route differently on the
    two paths);
15. mixtral_int8: full depth in int8, built one layer at a time (weight
    bytes, conversion seconds, peak memory); at 2 layers the int8
    forward against the fake-quant oracle, and at full depth flash
    against dense, both held with tied routers and reported with the
    random ones; generate() greedy on [2, 512] + 32 (forward launches
    zeroed before and 32 after); one decode step at batch 2, cache 544,
    beside the weight-read bound, with a torch.profiler pass; an Engine
    with 4 slots serving 4 requests (padded and chunked admission), and
    a lone request in it against a solo generate() (reported);

and after training:

16. lora_train: make_lora_train_step on the full-depth bf16 base, rank 8
    on wq / wv, flash + remat, [4, 2048]: one warm-up and three timed
    steps (launches 64 / 32 / 32 a step), then merge_lora,
    quantize_params and generate() of 16 tokens;

and last the Gemma phases, Gemma-2B (gemma_2b_config: head_dim 256, one
kv head, tied embedding; random weights from seeds, bf16, flash) through
the hd-256 kernels:

17. gemma_model: full depth, llama_forward flash against dense on
    [1, 1024] under the model phase's limits, generate() greedy on
    [2, 512] + 32 (18 forward launches), one decode step beside the
    weight-read bound with a torch.profiler pass, and a tiny hd-256
    Gemma on the card against the CPU;
18. gemma_train_grads: 2 layers, [1, 1024], llama_loss gradients flash
    against dense under the train_grads limits (launches 2 / 2 / 2);
19. gemma_train: full depth, [4, 2048], flash + remat, momentum SGD, as
    the train phase: step time, tokens/s, MFU, peak memory, launches
    36 / 18 / 18 a step;

and after them the sequence- and data-parallel paths, on ranks spawned
as processes on the one card in a gloo group (NCCL refuses two ranks on
one device, so the ranks' collectives stage device tensors through
pinned host memory: every time that crosses a hop is labelled
gloo_host_staged and measures that staging, with the ranks
time-sharing the card, never a ring on NVLink). The parent has built
the kernels (the ranks only load them) and holds no card memory; a rank
that fails a check raises, and the spawn fails the script:

20. sp_ring_kernels: ring_flash_attention at Llama-3-8B's heads, B 1,
    S 16384, bf16, at sp 2 and sp 4, causal and with a 4096 window, and
    at Gemma-2B's heads (hd 256, one kv head), S 8192, sp 2; Ulysses
    (flash) at sp 4. Each rank's output and dQ/dK/dV against the
    one-process flash_attention forward and backward on the whole
    sequence (O_ATOL, BWD_ATOL + BWD_RTOL |want|); its launches of each
    kernel counted around the sp call alone (r + 1 on rank r, causal;
    1 for Ulysses); its transport; then, one rank at a time, each hop's
    kernels timed alone at the ring's shapes and offsets (f32 gradient
    outputs) beside the whole-sequence kernels (rank 0), the last rank's
    diagonal block and nearest other block held against their plain
    versions (forward, and the backward with f32 outputs and delta
    passed in, as the ring calls them), and a hop's host staging timed
    alone; then one shift of every rank at once, with no kernel running;
21. sp_forward: Llama-3-8B at full width and depth, llama_forward over
    sp 2 on [1, 8192] (4096 a rank) against the one-device flash forward
    under forward_check's limits, 32 (rank 0) and 64 (rank 1) forward
    launches;
22. sp_train: Llama-3-8B at full width, SP_TRAIN_LAYERS deep, one
    momentum-SGD step from zero velocity at dp 1 x sp 4 and at dp 2 x
    sp 2 with remat, on [2, 4096], against the one-device
    make_train_step(None) step on the same tokens and initial params:
    the loss within 2e-3, each leaf kind's gradient, read from the
    velocity and recovered from the parameter delta (lr 1e4), within 3%
    of the kind's largest, the replicas' agreement, launches L·(s + 1)
    of each kernel on sp index s (the forward's twice under remat), and
    the host-staged gradient sum timed apart from the rest of the step
    (at dp 2 the params are FSDP shards, gathered leaf by leaf for the
    comparison);

and last the tensor-parallel paths, on ranks spawned the same way:

23. tp_forward: Llama-3-8B's llama_forward over tp 2 at full depth on
    [1, 2048] (each rank at its Hq 16, Hkv 4) and over tp 4 at
    TP4_FORWARD_LAYERS layers (Hq 8, Hkv 2), against the one-device
    flash forward under forward_check's limits, one forward launch a
    layer on each rank, the gathered logits the same on every rank;
24. tp_generate / tp_engine: at full depth over tp 2, greedy generate()
    on [2, 512] + 16 (32 forward launches a rank in its prefill) and an
    Engine over the head-sharded cache answering four requests (padded
    and chunked admission), then the int8 tree through
    shard_for_serving: the same tokens on every rank, each request's
    first token held to the one-device Engine's (or a near tie), the
    share of equal tokens reported, each rank's weight and cache bytes;
25. tp_train: TP_TRAIN_LAYERS layers at full width on [4, 2048], dp 2 x
    tp 2 with FSDP and remat, one momentum-SGD step against the
    one-device step under the sp_train bars (loss within TP_LOSS_LIMIT),
    launches 2L / L / L a rank, a rank's params a quarter of the whole
    plus its norms, the step's host time split by collective kind
    (comm.timed_collectives) and a second step without the split;
26. checkpoint: that state saved as DTensor shards and restored onto a
    ('tp',) mesh of 4 and onto one device, every gathered leaf
    bit-identical to the saved one; save and restore seconds and bytes;
27. tp_lora_train (on the two tp ranks): make_lora_train_step over tp 2,
    Llama-3-8B at TP_LORA_LAYERS layers, rank 8 on wq / wv, flash +
    remat, three Adam steps on [4, 2048] against the one-device LoRA
    step: losses within TP_LOSS_LIMIT, the adapters' first moments
    within 3%, launches 2L / L / L a step;
28. tp_spec_engine: SpecEngine over tp 2, the full-depth target on its
    shards and a 2-layer draft whole on each rank, four requests x 16:
    the same tokens on both ranks, agreement with one device reported;

and last the expert- and pipeline-parallel paths, on four ranks spawned
the same way (the mixtral_int8 phase leaves the one-device logits and
tokens they are held against, and the parent frees its tree first):

29. ep_layer: one full-width bf16 Mixtral MoE layer (seeded router and
    experts, 2048 seeded hidden states sharing one component so that
    capacity 640 binds) over ep 4 on [1,
    2048] and over dp 2 x ep 2 on [2, 1024], against one device's
    moe_mlp: the kept-pair set exactly (the global capacity race), the
    output within EP_REL_LIMIT, the bytes each collective received;
30. ep_forward / ep_generate: Mixtral-8x7B in int8 at full depth over ep
    4, each rank drawing the one-device tree's layers from the same
    per-layer seeds and keeping its 2 experts of each (about 12.7 GB a
    rank): llama_forward on [1, 2048] (32 forward launches a rank, the
    same logits on every rank, held to forward_check's bars against one
    device's) and generate() on [2, 512] + 16 (the same tokens on every
    rank, agreement reported);
31. ep_train: Mixtral at 2 layers, [4, 2048], dp 2 x ep 2, FSDP and
    remat, one momentum-SGD step against the one-device step under the
    tp_train bars; launches 4 / 2 / 2, param bytes, peak, the step split
    by collective kind;
32. pp_forward: Llama-3-8B at full depth through pipeline_llama_forward
    over pp 4 (8 layers a stage, drawn layer by layer), [4, 2048] in 4
    microbatches, against the one-device forward under forward_check's
    bars; 32 forward launches a rank (the bubble ticks skip their
    compute), the hops' and the broadcast's times;
33. pp_train: 8 layers, dp 2 x pp 2 with FSDP and remat, 2
    microbatches: pipeline_loss_and_grads against one device's llama_loss
    and gradients under the tp_train bars; launches 16 / 8 / 8 a rank,
    the bubble share, the step split by collective kind.

Every line but the last two is a JSON object; the card's name and power
limit (nvidia-smi) come second to last, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or outside a checkout of the repository, it prints no
result and exits non-zero.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), the bound's rates.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
O_ATOL = 2e-2      # bf16 O: about one bf16 ulp of values of order 1
LSE_ATOL = 1e-3    # f32 row statistics, different summation order
# Backward kernels against their plain version, elementwise
# |err| <= BWD_ATOL + BWD_RTOL * |want|: both round p and dS to bf16 at the
# same points, but on f32 values that differ in their last bits, and the
# bf16 gradients round once more.
BWD_ATOL = 1e-2
BWD_RTOL = 1e-2
# Two forwards of one bf16 model that differ only in how attention runs
# (flash against dense, the sp mesh against one device): the largest
# logit difference over the largest logit, the largest probability
# difference and the share of positions whose argmax agrees.
FWD_REL_LIMIT = 5e-2
FWD_PROB_LIMIT = 1e-2
FWD_ARGMAX_LIMIT = 0.8
# Flash against dense gradients of llama_loss (bf16 model), per leaf kind:
# max |g_flash - g_dense| over the kind's largest dense gradient, the
# forward check's own relative bar; the loss within 2e-2, the
# reference's flash-vs-dense loss bar (tests/ops/test_flash_attention.py).
GRAD_REL_LIMIT = FWD_REL_LIMIT
LOSS_LIMIT = 2e-2
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# Quantized forward against its fake-quant oracle (the same quantized
# weights, dequantized to bf16), relative Frobenius error of the logits:
# the two round the bf16 products at other points (widen-multiply-scale
# against multiply-by-dequantized), and int4 also sums its groups in f32.
QUANT_REL_LIMIT = {"int8": 3e-2, "int4": 5e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def visible_pairs(sq, skv, q_off, kv_off, causal, window) -> int:
    """(query, key) pairs this call's masks leave visible, per (b, h)."""
    if not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        hi = min(skv - 1, q_off + i - kv_off)
        lo = 0 if window is None else max(0, q_off + i - kv_off - window + 1)
        total += max(0, hi - lo + 1)
    return total


def attention_bound_ms(b, sq, skv, hq, hkv, hd, pairs):
    """Least time the card could take: QK^T and PV cost 4*hd operations
    per visible pair; q, k, v read once, O (bf16) and LSE (f32) written
    once. Returns (ms, "operations" | "bytes")."""
    flops = 4.0 * hd * pairs * b * hq
    nbytes = 2 * (b * sq * hq * hd + 2 * b * skv * hkv * hd + b * sq * hq * hd)
    nbytes += 4 * b * hq * sq
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(card, name, b, sq, skv, q_off=0, kv_off=0, causal=True,
                    window=None, timed=True, hq=32, hkv=8, hd=128,
                    q_transposed=False):
    """One kernel-vs-plain case, by default at the 8B attention shapes.
    ``q_transposed`` hands q over as a [B, S, H, hd] view of [B, H, S, hd]
    storage (the kernel reads it through its strides, no copy)."""
    import torch
    import torch.nn.functional as F

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.util.cuda_timing import device_ms, event_ms

    gen = torch.Generator(device="cuda").manual_seed(sq * 7 + skv)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if q_transposed:
        q = randn(b, hq, sq, hd).transpose(1, 2)
    else:
        q = randn(b, sq, hq, hd)
    k, v = randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)

    def kernel():
        return fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)

    def plain():
        return fa.flash_attention_reference(q, k, v, q_off, kv_off,
                                            causal=causal, window=window)

    out, lse = kernel()
    want, want_lse = plain()
    torch.cuda.synchronize()
    o_err = float((out.float() - want.float()).abs().max())
    neg_same = bool(torch.equal(torch.isneginf(lse), torch.isneginf(want_lse)))
    fin = torch.isfinite(want_lse)
    lse_err = float((lse[fin] - want_lse[fin]).abs().max()) if fin.any() else 0.0
    finite = bool(torch.isfinite(out.float()).all())
    empty_rows_zero = bool((out[torch.isneginf(lse).transpose(1, 2)[..., 0]] == 0).all())
    ok = (o_err <= O_ATOL and lse_err <= LSE_ATOL and neg_same and finite
          and empty_rows_zero)
    row = {
        "phase": "kernel", "case": name, "b": b, "sq": sq, "skv": skv,
        "hq": hq, "hkv": hkv, "hd": hd, "causal": causal, "window": window,
        "q_off": q_off, "kv_off": kv_off, "q_transposed": q_transposed,
        "empty_rows_zero": empty_rows_zero, "o_max_abs_err": o_err,
        "lse_max_abs_err": lse_err, "neg_inf_rows_match": neg_same,
        "o_atol": O_ATOL, "lse_atol": LSE_ATOL, "ok": ok, "card": card,
    }
    if timed:
        pairs = visible_pairs(sq, skv, q_off, kv_off, causal, window)
        bound, bound_by = attention_bound_ms(b, sq, skv, hq, hkv, hd, pairs)
        # SDPA wants [B, H, S, hd]; the layout change stays outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if causal and (window is not None or q_off or kv_off):
            qpos = q_off + torch.arange(sq, device="cuda")
            kpos = kv_off + torch.arange(skv, device="cuda")
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True,
            )

        row.update(
            kernel_ms=event_ms(kernel), plain_ms=event_ms(plain, reps=10),
            library_ms=event_ms(library), bound_ms=bound, bound_by=bound_by,
            kernel_device_ms=device_ms(kernel),
            library_device_ms=device_ms(library),
            visible_pairs_per_head=pairs,
        )
        row["kernel_tflops"] = 4.0 * hd * pairs * b * hq / row["kernel_ms"] / 1e9
    emit(row)
    if not ok:
        raise SystemExit(f"kernel case {name} disagrees with its plain version: {row}")
    return row


def bwd_ptxas() -> dict:
    """ptxas's registers and spills of flash_bwd.cu's twelve
    instantiations, keyed "<dq|dkv>_hd<64|128|256>_<bf16|f32>"."""
    from nos_tpu_torch.ops import _build

    report = {}
    for entry, figures in _build.ptxas_report("flash_bwd").items():
        kind = ("dkv" if "flash_dkv_kernel" in entry
                else "dq" if "flash_dq_kernel" in entry else None)
        for hd in (64, 128, 256):
            if kind and f"ILi{hd}E" in entry:
                out = "f32" if f"ILi{hd}EfE" in entry else "bf16"
                report[f"{kind}_hd{hd}_{out}"] = figures
    return report


def counts():
    """(forward, dQ, dK/dV) kernel launches so far."""
    import nos_tpu_torch.ops.flash_attention as fa

    return fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES


def zero_counts() -> None:
    import nos_tpu_torch.ops.flash_attention as fa

    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


def bwd_bound_ms(b, sq, skv, hq, hkv, hd, pairs, ops_per_pair, n_out_kv):
    """Least time for one backward kernel: ``ops_per_pair`` * hd
    operations per visible pair (dQ: S, dP, dQ products, 6; dK/dV: S, dP,
    dV, dK, 8) at the bf16 peak, against q, k, v, dO (bf16) and lse,
    delta (f32) read once and its outputs (bf16) written once: dQ's
    [b, sq, hq, hd], or dK and dV ([b, skv, hkv, hd] each, ``n_out_kv``
    2). Returns (ms, "operations" | "bytes")."""
    flops = ops_per_pair * hd * pairs * b * hq
    nbytes = 2 * (2 * b * sq * hq * hd + 2 * b * skv * hkv * hd) + 4 * 2 * b * hq * sq
    nbytes += 2 * (n_out_kv * b * skv * hkv * hd if n_out_kv else b * sq * hq * hd)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_backward(card, name, b, sq, skv, hq=32, hkv=8, hd=128, q_off=0,
                   kv_off=0, causal=True, window=None, timed=False, grad_dtype=None):
    """dQ and dK/dV kernels against their plain version on one case, the
    gradients written in bf16 or in ``grad_dtype`` (f32); at ``timed``,
    each kernel's time beside its bound, its profiler device time, the
    plain version and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.util.cuda_timing import device_ms, event_ms

    gen = torch.Generator(device="cuda").manual_seed(sq * 13 + skv + hd)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(b, sq, hq, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    do = randn(b, sq, hq, hd)
    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)
    delta = fa.flash_delta(do, out)
    kw = dict(causal=causal, window=window, delta=delta, grad_dtype=grad_dtype)
    got = fa.flash_block_grads(q, k, v, out, lse, do, q_off, kv_off, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off, kv_off, **kw)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        ok = ok and g.dtype == (grad_dtype or torch.bfloat16)
        g, w = g.float(), w.float()
        errs[gname] = float((g - w).abs().max())
        ok = ok and bool(((g - w).abs() <= BWD_ATOL + BWD_RTOL * w.abs()).all())
        ok = ok and bool(torch.isfinite(g).all())
    if bool(torch.isneginf(lse).all()):  # no visible key anywhere: exact zeros
        ok = ok and all(bool((g == 0).all()) for g in got)
    row = {
        "phase": "kernel_bwd", "case": name, "b": b, "sq": sq, "skv": skv,
        "hq": hq, "hkv": hkv, "hd": hd, "causal": causal, "window": window,
        "q_off": q_off, "kv_off": kv_off,
        "grad_dtype": "f32" if grad_dtype == torch.float32 else "bf16",
        **{f"{g}_max_abs_err": e for g, e in errs.items()},
        "atol": BWD_ATOL, "rtol": BWD_RTOL, "ok": ok, "card": card,
    }
    if timed:
        pairs = visible_pairs(sq, skv, q_off, kv_off, causal, window)
        args = (q, k, v, lse, do, delta, q_off, kv_off, causal, window, grad_dtype)
        for kname, which in (("dq", (True, False)), ("dkv", (False, True))):
            row[f"{kname}_ms"] = event_ms(lambda: fa._flash_bwd_cuda(*args, *which))
            row[f"{kname}_device_ms"] = device_ms(lambda: fa._flash_bwd_cuda(*args, *which))
        row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound_ms(
            b, sq, skv, hq, hkv, hd, pairs, 6, 0)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound_ms(
            b, sq, skv, hq, hkv, hd, pairs, 8, 2)
        row["plain_ms"] = event_ms(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off,
                                                     kv_off, **kw),
            reps=3, warmup=1)
        # SDPA (a yardstick the port never calls): forward+backward minus
        # forward, [B, H, S, hd] copies made outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        row["sdpa_fwd_ms"] = event_ms(sdpa)
        row["sdpa_fwd_bwd_ms"] = event_ms(sdpa_fwd_bwd)
        row["library_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
        row["visible_pairs"] = pairs * b * hq
        for kname, ops in (("dq", 6), ("dkv", 8)):
            row[f"{kname}_tflops"] = ops * hd * pairs * b * hq / row[f"{kname}_ms"] / 1e9
    emit(row)
    if not ok:
        raise SystemExit(f"backward case {name} disagrees with its plain version: {row}")
    return row


def logits_agreement(got, want) -> dict:
    """The statistics of ``got`` logits against ``want``'s that the FWD_*
    limits bound."""
    import torch

    diff = (got - want).abs()
    return {"logits_max_abs_diff": float(diff.max()),
            "logits_max_rel_diff": float(diff.max() / want.abs().max()),
            "probs_max_abs_diff": float((torch.softmax(got, -1)
                                         - torch.softmax(want, -1)).abs().max()),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def logits_hold(stats, probs_limit: float = FWD_PROB_LIMIT) -> bool:
    return (stats["finite"] and stats["logits_max_rel_diff"] <= FWD_REL_LIMIT
            and stats["probs_max_abs_diff"] <= probs_limit
            and stats["argmax_agreement"] >= FWD_ARGMAX_LIMIT)


def forward_check(card, phase, params, cfg, tokens, scale_prob_limit=False) -> dict:
    """llama_forward on ``tokens`` with flash (its launches counted, one a
    layer) against dense, held to the FWD_* limits. Both paths round their
    logits to bf16, whose spacing u at the largest logit grows with it;
    one spacing on each logit can move a probability by up to u / 2
    (|dp_i| <= 2 p_i (1 - p_i) u). With ``scale_prob_limit`` (Gemma: its
    scaled, tied embedding gives logits near 17, where u = 2^-3) the
    probability limit is max(FWD_PROB_LIMIT, u / 2)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.models import llama

    with torch.no_grad():
        fa.LAUNCHES = 0
        flash_logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        forward_launches = fa.LAUNCHES
        dense_logits = llama.llama_forward(
            params, tokens, dataclasses.replace(cfg, attention="dense"))
        stats = logits_agreement(flash_logits, dense_logits)
        spacing = 2.0 ** (math.floor(math.log2(float(dense_logits.abs().max()))) - 7)
    p_limit = max(FWD_PROB_LIMIT, spacing / 2) if scale_prob_limit else FWD_PROB_LIMIT
    row = {"phase": phase, "tokens": list(tokens.shape),
           "flash_launches": forward_launches, **stats,
           "logits_bf16_spacing": spacing, "probs_limit": p_limit, "card": card}
    row["ok"] = forward_launches == cfg.n_layers and logits_hold(stats, p_limit)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"flash forward disagrees with dense: {row}")
    return row


def generate_check(card, phase, params, cfg, prompt, new_tokens=32):
    """The serving main path: greedy generate() with the forward kernel's
    count zeroed just before and read just after (one launch a layer, in
    the unpadded prefill). Returns (launches, tokens)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.models import generate as gen_mod

    with torch.no_grad():
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.time()
        out = gen_mod.generate(params, prompt, cfg, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fa.LAUNCHES
    ok = (tuple(out.shape) == (prompt.shape[0], new_tokens) and launches == cfg.n_layers
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit({"phase": phase, "prompt": list(prompt.shape), "new_tokens": new_tokens,
          "flash_launches": launches, "seconds": wall,
          "tokens_per_s": prompt.shape[0] * new_tokens / wall, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"generate() failed: shape {tuple(out.shape)}, "
                         f"launches {launches}")
    return launches, out


def decode_check(card, phase, profile_phase, params, cfg, prompt, first,
                 n_params, new_tokens=32) -> dict:
    """One decode step at the generate shapes, beside the weight-read bound
    (bf16 weights read once), then a torch.profiler pass over eight."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod

    b, s = prompt.shape
    with torch.no_grad():
        _, cache = gen_mod.prefill(params, prompt, cfg, s + new_tokens)

        def decode_steps(n, token=first):
            for i in range(n):
                logits, _ = gen_mod.decode_step(params, cache, s + i, token, cfg)
                token = logits.argmax(dim=-1)
            torch.cuda.synchronize()

        decode_steps(2)
        t0 = time.time()
        decode_steps(16)
        step_ms = (time.time() - t0) / 16 * 1e3
        row = {"phase": phase, "batch": b, "cache_len": s + new_tokens,
               "ms_per_step": step_ms,
               "weight_read_bound_ms": 2 * n_params / PEAK_HBM_BYTES_S * 1e3,
               "card": card}
        emit(row)
        row["profile"] = profile_steps(decode_steps, card, step_ms, phase=profile_phase)
        emit(row["profile"])
    return row


def tiny_check(card, phase, tiny, gen) -> dict:
    """A small input against a reference: the same tiny model (bf16,
    flash) on the card and on the CPU, logits within 1e-1."""
    import torch

    from nos_tpu_torch.models import llama

    tiny_gpu = llama.init_llama_params(tiny, seed=3, device="cuda")
    tiny_cpu = llama.tree_map(lambda x: x.cpu(), tiny_gpu)
    small = torch.randint(0, tiny.vocab_size, (2, 96), generator=gen, device="cuda")
    with torch.no_grad():
        a = llama.llama_forward(tiny_gpu, small, tiny).cpu()
        b = llama.llama_forward(tiny_cpu, small.cpu(), tiny)
    err = float((a - b).abs().max())
    row = {"phase": phase, "head_dim": tiny.head_dim, "logits_max_abs_diff": err,
           "atol": 1e-1, "ok": err <= 1e-1 and bool(torch.isfinite(a).all()),
           "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"tiny model on the card disagrees with the CPU: {row}")
    return row


def gemma_kernel_phases(card) -> dict:
    """The three kernels at head_dim 256 (Gemma-2B's attention: Hq 8,
    Hkv 1) against their plain versions: the edges of the forward's
    64-key tiles, the backward's 64-row query tiles, 64-key dK/dV blocks
    and 32-key dQ tiles (S 63 / 64 / 65 / 127 / 129), Skv 1, offsets off
    the grid with a window, MQA and GQA, q as a transposed view, f32
    gradient outputs; timed at the generate() prefill shape [2, 512] and
    the training shape [4, 2048] (causal)."""
    g = dict(hd=256, hq=8, hkv=1)
    rows = {}
    for n in (63, 64, 65, 127, 129):
        check_attention(card, f"hd256_ragged_s{n}", 1, n, n, timed=False, **g)
    check_attention(card, "hd256_skv_1", 2, 50, 1, timed=False, **g)
    check_attention(card, "hd256_window200_offsets_off_tile", 1, 300, 400, q_off=333,
                    kv_off=45, window=200, timed=False, hd=256, hq=4, hkv=2)
    check_attention(card, "hd256_q_transposed_view", 2, 200, 200, q_transposed=True,
                    timed=False, **g)
    check_attention(card, "hd256_gqa_noncausal", 2, 77, 77, causal=False, timed=False,
                    hd=256, hq=8, hkv=2)
    rows["fwd_prefill"] = check_attention(card, "hd256_gemma_prefill_b2_s512", 2, 512,
                                          512, **g)
    rows["fwd_train"] = check_attention(card, "hd256_gemma_train_b4_s2048", TRAIN_BATCH,
                                        TRAIN_SEQ, TRAIN_SEQ, **g)
    for n in (63, 64, 65, 127, 129):
        check_backward(card, f"hd256_ragged_s{n}", 1, n, n, **g)
    check_backward(card, "hd256_skv_1", 2, 50, 1, **g)
    check_backward(card, "hd256_window200_offsets_off_tile", 1, 300, 400, q_off=333,
                   kv_off=45, window=200, hd=256, hq=4, hkv=2)
    check_backward(card, "hd256_gqa_s300", 2, 300, 300, hd=256, hq=8, hkv=2)
    check_backward(card, "hd256_gqa_noncausal", 2, 77, 77, causal=False, hd=256, hq=8,
                   hkv=2)
    import torch

    check_backward(card, "hd256_f32_grads_window37", 1, 200, 200, window=37,
                   grad_dtype=torch.float32, **g)
    check_backward(card, "hd256_f32_grads_offsets", 1, 64, 96, q_off=40, kv_off=20,
                   window=50, grad_dtype=torch.float32, **g)
    rows["bwd_train"] = check_backward(card, "hd256_gemma_train_b4_s2048", TRAIN_BATCH,
                                       TRAIN_SEQ, TRAIN_SEQ, timed=True, **g)
    return rows


def gemma_model_phase(card) -> dict:
    """Gemma-2B at full width and depth (random weights from a seed, bf16,
    attention="flash", the tied embedding as its unembedding):
    llama_forward flash against dense on [1, 1024], greedy generate() on
    [2, 512] + 32 (18 forward launches), one decode step beside the
    weight-read bound with a profile, and a tiny head_dim-256 Gemma on the
    card against the CPU."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.gemma_2b_config(), attention="flash")
    t0 = time.time()
    params = llama.init_llama_params(cfg, seed=21, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama.tree_leaves(params))
    emit({"phase": "gemma_init", "config": "gemma_2b", "params": n_params,
          "seconds": time.time() - t0, "gib": torch.cuda.memory_allocated() / 2**30,
          "card": card})
    gen = torch.Generator(device="cuda").manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    forward = forward_check(card, "gemma_forward", params, cfg, tokens,
                            scale_prob_limit=True)
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    launches, out = generate_check(card, "gemma_generate", params, cfg, prompt)
    decode = decode_check(card, "gemma_decode_step", "gemma_decode_profile", params, cfg,
                          prompt, out[:, 0], n_params)
    tiny_check(card, "gemma_tiny_card_vs_cpu", llama.tiny_config(
        d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, qk_head_dim=256,
        hidden_act="gelu", norm_offset=True, scale_embeddings=True,
        tie_embeddings=True, attention="flash"), gen)
    return {"params": n_params, "forward": forward, "generate_launches": launches,
            "decode": decode}


def changed_fraction(before, after) -> float:
    """Share of elements that differ between two lists of tensors."""
    changed = sum(int((a != b).sum()) for a, b in zip(before, after))
    return changed / sum(a.numel() for a in before)


def named_leaves(params):
    """(kind, tensor) in the order of nos_tpu_torch.parallel.train.tree_leaves;
    a MoE layer's leaves are "moe.router", "moe.w_gate", ..."""
    for key, value in params.items():
        if key == "layers":
            for layer in value:
                for name, leaf in layer.items():
                    if isinstance(leaf, dict):
                        yield from ((f"{name}.{k}", v) for k, v in leaf.items())
                    else:
                        yield name, leaf
        else:
            yield key, value


def flash_dense_grads(params, tokens, cfg) -> dict:
    """llama_loss and its gradients on the flash path (the kernels)
    against the dense path (autograd of the einsums): the losses, each
    leaf kind's max |g_flash - g_dense| over its largest dense gradient,
    and the kernel launches of the flash pass alone."""
    import torch

    from nos_tpu_torch.models import llama

    named = list(named_leaves(params))
    leaves = [t.requires_grad_(True) for _, t in named]

    def loss_and_grads(c):
        loss = llama.llama_loss(params, tokens, c)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    zero_counts()
    loss_f, grads_f = loss_and_grads(cfg)
    torch.cuda.synchronize()
    launches = counts()
    loss_d, grads_d = loss_and_grads(dataclasses.replace(cfg, attention="dense"))
    diff, ref = {}, {}
    for (kind, _), gf, gd in zip(named, grads_f, grads_d):
        diff[kind] = max(diff.get(kind, 0.0), float((gf.float() - gd.float()).abs().max()))
        ref[kind] = max(ref.get(kind, 0.0), float(gd.float().abs().max()))
    return {"loss_flash": float(loss_f), "loss_dense": float(loss_d),
            "loss_abs_diff": abs(float(loss_f) - float(loss_d)),
            "grad_rel_err": {kind: diff[kind] / ref[kind] for kind in diff},
            "launches_fwd_dq_dkv": list(launches),
            "finite": all(bool(torch.isfinite(g.float()).all()) for g in grads_f)}


def grads_hold(res, n_layers) -> bool:
    return (res["finite"] and res["loss_abs_diff"] <= LOSS_LIMIT
            and max(res["grad_rel_err"].values()) <= GRAD_REL_LIMIT
            and res["launches_fwd_dq_dkv"] == [n_layers] * 3)


def train_grads_phase(card, base=None, phase="train_grads", seed=5) -> dict:
    """llama_loss gradients at full width (``base``, by default
    Llama-3-8B), 2 layers, [1, 1024]: the flash path (kernels) against the
    dense path (autograd of the einsums)."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = dataclasses.replace(base or llama.llama_3_8b_config(), n_layers=2,
                              attention="flash")
    params = llama.init_llama_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    row = {"phase": phase, "layers": 2, "tokens": [1, 1024],
           **flash_dense_grads(params, tokens, cfg),
           "loss_limit": LOSS_LIMIT, "grad_rel_limit": GRAD_REL_LIMIT, "card": card}
    row["ok"] = grads_hold(row, cfg.n_layers)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"flash gradients disagree with dense: {row}")
    return row


def train_phase(card, base=None, config="llama_3_8b", phase="train", seed=7) -> dict:
    """The trainer's main path: ``base`` (by default Llama-3-8B) at full
    width and depth, flash + remat, built-in momentum SGD, batches from
    BatchLoader through prefetch_to_device."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    cfg = dataclasses.replace(base or llama.llama_3_8b_config(), attention="flash",
                              remat=True)
    torch.cuda.reset_peak_memory_stats()
    # bf16 weights of order 2^-6 have a half-ulp of 6e-5: an SGD update
    # below that rounds away, and at lr 1e-3 none of the probed weights
    # moved in three steps from the random init. lr 1.0 makes the update
    # visible; the step's work is the same at any lr.
    step, shard_state = make_train_step(None, cfg, learning_rate=1.0)
    state = shard_state(llama.init_llama_params(cfg, seed=seed, device="cuda"),
                        donate=True)
    params = state[0]
    # a tied model's unembedding is its embedding
    unembed = params.get("lm_head", params["embed"])
    probes = [unembed, params["layers"][0]["wq"], params["layers"][-1]["w_down"]]
    before = [t.detach().clone() for t in probes]
    layer_mm = sum(params["layers"][0][key].numel() for key in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    matmul_params = layer_mm * cfg.n_layers + unembed.numel()
    corpus = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=1 << 22).astype(np.int32)
    loader = BatchLoader(corpus, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
    stream = prefetch_to_device(iter(loader))
    torch.cuda.synchronize()
    zero_counts()  # the main path: every launch from here on is the trainer's
    step_ms, losses, per_step = [], [], []
    for _ in range(4):  # one warm-up, three timed
        at_start = counts()
        t0 = time.perf_counter()
        state, loss = step(state, next(stream))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(counts(), at_start)))
    totals = counts()
    timed_ms = statistics.median(step_ms[1:])
    holder = [state]

    def more_steps(n):
        for _ in range(n):
            holder[0], _ = step(holder[0], next(stream))
        torch.cuda.synchronize()

    # one more step under torch.profiler, after the counts were read
    emit(profile_steps(more_steps, card, timed_ms, steps=1, phase=f"{phase}_profile"))
    stream.close()
    losses = [float(x) for x in losses]
    changed = changed_fraction(before, probes)
    del before
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2 * TRAIN_BATCH * cfg.n_heads
    flops = 6.0 * matmul_params * tokens + 3 * 4.0 * cfg.head_dim * pairs * cfg.n_layers
    expect = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    row = {"phase": phase, "config": config, "layers": cfg.n_layers,
           "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "optimizer": "momentum_sgd(lr=1.0, momentum=0.9)",
           "remat": True, "step_ms": step_ms, "ms_per_step": timed_ms,
           "tokens_per_s": tokens / timed_ms * 1e3,
           "model_flops_per_step": flops,
           "mfu": flops / (timed_ms / 1e3) / PEAK_BF16_FLOPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step_fwd_dq_dkv": [list(x) for x in per_step],
           "launches_total_fwd_dq_dkv": list(totals), "losses": losses,
           "probed_params_changed_fraction": changed, "card": card}
    row["ok"] = (all(x == expect for x in per_step) and changed > 0
                 and all(np.isfinite(losses)))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"train phase failed: {row}")
    return row


def train_adamw_phase(card) -> dict:
    """4 layers at full width, the AdamW factory, accum_steps=2."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=4,
                              attention="flash", remat=True)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.01)
    step, shard_state = make_train_step(None, cfg, optimizer=factory, accum_steps=2)
    state = shard_state(llama.init_llama_params(cfg, seed=9, device="cuda"),
                        donate=True)
    corpus = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=1 << 20).astype(np.int32)
    stream = prefetch_to_device(iter(BatchLoader(corpus, batch=4, seq_len=TRAIN_SEQ,
                                                 seed=9)))
    probe = state[0]["layers"][3]["w_down"]
    before = [probe.detach().clone()]
    zero_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(2):
        state, loss = step(state, next(stream))
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream.close()
    losses = [float(x) for x in losses]
    launches = counts()
    expect = (2 * 2 * 2 * cfg.n_layers, 2 * 2 * cfg.n_layers, 2 * 2 * cfg.n_layers)
    changed = changed_fraction(before, [probe])
    row = {"phase": "train_adamw", "layers": cfg.n_layers, "batch": [4, TRAIN_SEQ],
           "accum_steps": 2, "optimizer": "torch.optim.AdamW(lr=1e-4, wd=0.01)",
           "losses": losses, "seconds": wall, "launches_fwd_dq_dkv": list(launches),
           "probed_params_changed_fraction": changed, "card": card}
    row["ok"] = bool(all(np.isfinite(losses)) and changed > 0 and launches == expect)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"train_adamw phase failed: {row}")
    return row


def quantize_phase(card, params, cfg) -> dict:
    """int8 and int4 trees of the full model, and their 2-layer parity
    against the fake-quant oracle."""
    import torch

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import quantize as tq

    trees = {"bf16": params}
    seconds = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fmt, fn in (("int8", tq.quantize_params),
                    ("int4", lambda p: tq.quantize_params_int4(p, group=128))):
        t0 = time.time()
        trees[fmt] = fn(params)
        torch.cuda.synchronize()
        seconds[fmt] = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = {"phase": "quantize", "config": "llama_3_8b",
           "weight_bytes": {k: tq.weight_bytes(v) for k, v in trees.items()},
           "seconds": seconds, "conversion_peak_gib": peak, "int4_group": 128,
           "parity_layers": 2, "parity_tokens": [1, 1024],
           "rel_limit": QUANT_REL_LIMIT, "card": card}
    two = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    ok = True
    with torch.no_grad():
        for fmt in ("int8", "int4"):
            sliced = dict(trees[fmt], layers=trees[fmt]["layers"][:2])
            got = llama.llama_forward(sliced, tokens, two)
            want = llama.llama_forward(tq.dequantize_params(sliced, cfg.dtype), tokens, two)
            rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
            row[fmt] = {
                "max_abs_err": float((got - want).abs().max()),
                "rel_frobenius_err": rel,
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(got).all()),
            }
            ok = ok and row[fmt]["finite"] and rel <= QUANT_REL_LIMIT[fmt]
            del got, want
    row["ok"] = ok
    emit(row)
    if not ok:
        raise SystemExit(f"quantized forward disagrees with its oracle: {row}")
    return trees


def generate_quant_phase(card, trees, cfg, prompt) -> list:
    """generate() on [2, 512] + 32 over quantized weights, forward
    launches counted around each run."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod

    rows = []
    for fmt, kv_quant in (("int8", False), ("int8", True), ("int4", True)):
        with torch.no_grad():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.time()
            out = gen_mod.generate(trees[fmt], prompt, cfg, max_new_tokens=32,
                                   kv_quant=kv_quant)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = counts()[0]
            peak = torch.cuda.max_memory_allocated()
        # peak_gib includes every resident tree (bf16, int8, int4);
        # above_resident_gib is what this generate() itself allocated at
        # its peak (the prefill's activations, the int4 [rows, G, out]
        # partials, the cache)
        row = {"phase": "generate_quant", "weights": fmt, "kv_quant": kv_quant,
               "prompt": list(prompt.shape), "new_tokens": 32,
               "flash_launches": launches, "seconds": wall,
               "tokens_per_s": prompt.shape[0] * 32 / wall,
               "peak_gib": peak / 2**30, "above_resident_gib": (peak - resident) / 2**30,
               "card": card}
        row["ok"] = (tuple(out.shape) == (prompt.shape[0], 32)
                     and launches == cfg.n_layers
                     and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
        emit(row)
        if not row["ok"]:
            raise SystemExit(f"quantized generate() failed: {row}")
        rows.append(row)
    return rows


def decode_quant_phase(card, trees, cfg, prompt, first) -> list:
    """One decode step per weight format and cache kind, beside the
    weight-read bound; the int8 step under torch.profiler; a large cache."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import quantize as tq
    from nos_tpu_torch.models.decode_bench import time_decode

    rows = []
    with torch.no_grad():
        for fmt in ("bf16", "int8", "int4"):
            wbytes = tq.weight_bytes(trees[fmt])
            for kv_quant in (False, True):
                ms, run = time_decode(trees[fmt], cfg, prompt, first, kv_quant,
                                      max_len=prompt.shape[1] + 32)
                row = {"phase": "decode_quant", "weights": fmt, "kv_quant": kv_quant,
                       "batch": prompt.shape[0], "cache_len": prompt.shape[1] + 32,
                       "ms_per_step": ms, "weight_bytes": wbytes,
                       "weight_read_bound_ms": wbytes / PEAK_HBM_BYTES_S * 1e3,
                       "card": card}
                emit(row)
                rows.append(row)
                if fmt != "bf16" and not kv_quant:
                    row = profile_steps(run, card, ms, phase="decode_quant_profile")
                    emit(dict(row, weights=fmt))
                del run
        # a long cache: batch 4, max_len 4096, random contents (the port's
        # cache attention reads every slot whatever the frontier)
        gen = torch.Generator(device="cuda").manual_seed(13)
        token = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
        for kv_quant in (False, True):
            cache = gen_mod.init_kv_cache(cfg, 4, 4096, quant=kv_quant)
            for layer in cache:
                for key, buf in layer.items():
                    if buf.dtype == torch.int8:
                        buf.random_(-127, 128, generator=gen)
                    elif key.endswith("scale"):
                        buf.uniform_(0.005, 0.02, generator=gen)
                    else:
                        buf.normal_(generator=gen)
            kv_bytes = sum(b.numel() * b.element_size() for layer in cache
                           for b in layer.values())
            pos = torch.full((4,), 4000, device="cuda")

            def step():
                gen_mod.decode_step(trees["bf16"], cache, pos, token, cfg)

            step()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(4):
                step()
            torch.cuda.synchronize()
            row = {"phase": "decode_long_cache", "weights": "bf16",
                   "kv_quant": kv_quant, "batch": 4, "max_len": 4096,
                   "kv_bytes": kv_bytes, "ms_per_step": (time.time() - t0) / 4 * 1e3,
                   "kv_read_bound_ms": kv_bytes / PEAK_HBM_BYTES_S * 1e3, "card": card}
            emit(row)
            rows.append(row)
            del cache
    return rows


def engine_quant_lora_phase(card, trees, cfg, prompts) -> None:
    """(a) the engine workload over int8 weights and an int8 cache; (b) a
    multi-LoRA Engine against the bare base in the same batch shape."""
    import torch

    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.serve import Engine, GenRequest
    from nos_tpu_torch.util import metrics

    hits0 = metrics.SERVE_PREFIX_HITS.value
    eng = Engine(trees["int8"], cfg, max_slots=4, max_len=1024, prefill_chunk=256,
                 prefix_cache_entries=2, kv_quant=True)
    with torch.no_grad():
        t0 = time.time()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    hits = metrics.SERVE_PREFIX_HITS.value - hits0
    row = {"phase": "engine_quant", "weights": "int8", "kv_quant": True,
           "requests": len(ids), "prompt_tokens": [len(p) for p in prompts],
           "new_tokens": 32, "prefix_hits": hits, "seconds": wall,
           "tokens_per_s": 32 * len(ids) / wall, "card": card}
    row["ok"] = hits >= 1 and all(
        len(results[i]) == 32 and all(0 <= t < cfg.vocab_size for t in results[i])
        for i in ids)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"int8 engine failed: {row}")
    del eng

    lora = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    adapters = []
    for seed in (21, 22):
        ad = tlora.init_lora_params(cfg, lora, seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for layer in ad["layers"]:
            for ab in layer.values():
                ab["b"].normal_(0.0, 0.05, generator=gen)
        adapters.append(ad)
    stacked = tlora.stack_lora_adapters(trees["bf16"], adapters, lora, rows=3)
    lora_prompts = [prompts[0], prompts[4], prompts[5]]
    out = {}
    for name, params, adapter_ids in (("lora", stacked, (0, 1, 2)),
                                      ("base", trees["bf16"], (0, 0, 0))):
        eng = Engine(params, cfg, max_slots=3, max_len=512)
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32, adapter=a))
                   for p, a in zip(lora_prompts, adapter_ids)]
            got = eng.run()
            torch.cuda.synchronize()
            out[name] = ([got[i] for i in ids], time.time() - t0)
    (lora_toks, lora_s), (base_toks, base_s) = out["lora"], out["base"]
    row = {"phase": "engine_multi_lora", "adapters": 2, "rank": 8,
           "targets": list(lora.targets), "requests_adapters": [0, 1, 2],
           "prompt_tokens": [len(p) for p in lora_prompts], "new_tokens": 32,
           "seconds": lora_s, "tokens_per_s": 96 / lora_s,
           "base_engine_tokens_per_s": 96 / base_s,
           "adapter0_equals_base": lora_toks[0] == base_toks[0],
           "adapter_differs_from_base": [lora_toks[i] != base_toks[i] for i in (1, 2)],
           "card": card}
    row["ok"] = (row["adapter0_equals_base"] and all(row["adapter_differs_from_base"])
                 and all(len(x) == 32 for x in lora_toks))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"multi-LoRA engine failed: {row}")


def spec_engine_phase(card, params, cfg, prompts, k=4, chunk=16) -> None:
    """SpecEngine over the full-depth target with two drafts: its first
    two layers (sharing the embedding and lm_head), and the target
    itself (every draft should be accepted, up to chunk-vs-step drift).
    Two base Engines serve the same requests for comparison: one admits
    through padded dense prefill (every prompt here fits one bucket),
    the other through the same ``chunk``-token pieces as SpecEngine, so
    that its agreement leaves only the verify-vs-step drift."""
    import torch

    from nos_tpu_torch.serve import Engine, GenRequest, SpecEngine

    def serve(eng):
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.time() - t0

    def agreement(toks, ref):
        same = sum(a == b for s_, r_ in zip(toks, ref) for a, b in zip(s_, r_))
        # tokens up to each request's first divergence
        prefix = [next((i for i, (a, b) in enumerate(zip(s_, r_)) if a != b), 32)
                  for s_, r_ in zip(toks, ref)]
        return same / (32 * len(prompts)), prefix

    assert all(len(p) > chunk for p in prompts), "every prompt must span pieces"
    base_toks, base_s = serve(Engine(params, cfg, max_slots=4, max_len=512))
    chunked_toks, _ = serve(Engine(params, cfg, max_slots=4, max_len=512,
                                   prefill_chunk=chunk))
    share, prefix = agreement(chunked_toks, base_toks)
    emit({"phase": "spec_engine_witness", "prefill_chunk": chunk,
          "chunked_base_share_equal_to_padded_base": share,
          "tokens_before_first_divergence": prefix, "card": card})
    drafts = (("first_2_layers", dict(params, layers=params["layers"][:2]),
               dataclasses.replace(cfg, n_layers=2)),
              ("target_itself", params, cfg))
    for name, draft, draft_cfg in drafts:
        spec = SpecEngine(params, cfg, draft, draft_cfg, k=k, max_slots=4, max_len=512,
                          prefill_chunk=chunk)
        spec_toks, spec_s = serve(spec)
        stats = spec.stats()
        share, prefix = agreement(spec_toks, base_toks)
        share_chunked, prefix_chunked = agreement(spec_toks, chunked_toks)
        row = {"phase": "spec_engine", "draft": name, "draft_layers": draft_cfg.n_layers,
               "k": k, "prefill_chunk": chunk, "requests": len(prompts),
               "prompt_tokens": [len(p) for p in prompts],
               "new_tokens": 32, "rounds": stats["rounds"],
               "mean_accepted": stats["mean_accepted"], "seconds": spec_s,
               "tokens_per_s": 32 * len(prompts) / spec_s,
               "base_engine_tokens_per_s": 32 * len(prompts) / base_s,
               "share_equal_to_base_engine": share,
               "tokens_before_first_divergence": prefix,
               "share_equal_to_chunked_base_engine": share_chunked,
               "tokens_before_first_divergence_chunked": prefix_chunked,
               "card": card}
        row["ok"] = (all(len(x) == 32 for x in spec_toks)
                     and all(0 <= t < cfg.vocab_size for x in spec_toks for t in x)
                     and 0.0 <= stats["mean_accepted"] <= k)
        emit(row)
        if not row["ok"]:
            raise SystemExit(f"spec engine failed: {row}")
        del spec


def base_checksums(params) -> list:
    """Two integers per leaf of a bf16 params tree: the sums of its bits
    read as int16 and of their squares (a cheap witness that no frozen
    leaf was written, without a second copy of the weights)."""
    import torch

    from nos_tpu_torch.models.llama import tree_leaves

    sums = []
    for leaf in tree_leaves(params):
        bits = leaf.view(torch.int16).int()
        sums += [bits.sum(dtype=torch.int64), (bits * bits).sum(dtype=torch.int64)]
        del bits
    return torch.stack(sums).tolist()


def lora_train_phase(card) -> dict:
    """LoRA fine-tuning at full width and depth, then finetune_lora.py's
    serving path: merge, int8, generate."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.models.quantize import quantize_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash", remat=True)
    torch.cuda.reset_peak_memory_stats()
    base = llama.init_llama_params(cfg, seed=17, device="cuda")
    lora = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    step, shard = tlora.make_lora_train_step(None, cfg, lora, learning_rate=1e-3)
    state = shard(tlora.init_lora_params(cfg, lora, seed=17))
    b_before = [state[0]["layers"][i]["wq"]["b"].detach().clone() for i in (0, -1)]
    base_before = base_checksums(base)
    corpus = np.random.default_rng(17).integers(
        0, cfg.vocab_size, size=1 << 22).astype(np.int32)
    stream = prefetch_to_device(iter(BatchLoader(corpus, batch=TRAIN_BATCH,
                                                 seq_len=TRAIN_SEQ, seed=17)))
    torch.cuda.synchronize()
    zero_counts()
    step_ms, losses, per_step = [], [], []
    for _ in range(4):  # one warm-up, three timed
        at_start = counts()
        t0 = time.perf_counter()
        state, loss = step(state, base, next(stream))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append(tuple(a - b for a, b in zip(counts(), at_start)))
    stream.close()
    timed_ms = statistics.median(step_ms[1:])
    b_moved = all(not torch.equal(state[0]["layers"][i]["wq"]["b"].detach(), before)
                  for i, before in zip((0, -1), b_before))
    base_same = base_checksums(base) == base_before
    tokens = TRAIN_BATCH * TRAIN_SEQ
    expect = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    row = {"phase": "lora_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "rank": 8, "targets": list(lora.targets), "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "optimizer": "torch.optim.Adam(lr=1e-3)", "remat": True,
           "step_ms": step_ms, "ms_per_step": timed_ms,
           "tokens_per_s": tokens / timed_ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step_fwd_dq_dkv": [list(x) for x in per_step],
           "losses": losses, "adapter_b_moved": b_moved,
           "base_leaves_checked": len(base_before) // 2,
           "base_bit_identical": base_same, "card": card}
    row["ok"] = (all(x == expect for x in per_step) and b_moved and base_same
                 and all(np.isfinite(losses)))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"lora_train phase failed: {row}")
    # finetune_lora.py's serving path: merge, quantize, generate
    with torch.no_grad():
        adapters = {"layers": [{t: {k: v.detach() for k, v in ab.items()}
                                for t, ab in layer.items()}
                               for layer in state[0]["layers"]]}
        del state
        merged = tlora.merge_lora(base, adapters, lora)
        served = quantize_params(merged)
        del merged, base
        gen = torch.Generator(device="cuda").manual_seed(18)
        prompt = torch.randint(1, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
        zero_counts()
        t0 = time.time()
        out = gen_mod.generate(served, prompt, cfg, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.time() - t0
    serve = {"phase": "lora_merge_int8_generate", "prompt": [2, 128], "new_tokens": 16,
             "seconds": wall, "flash_launches": counts()[0], "card": card}
    serve["ok"] = (tuple(out.shape) == (2, 16) and serve["flash_launches"] == cfg.n_layers
                   and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit(serve)
    if not serve["ok"]:
        raise SystemExit(f"merged int8 serving failed: {serve}")
    return row


def mixtral_config(**overrides):
    """Mixtral-8x7B's shape (mistralai/Mixtral-8x7B-v0.1, config.json):
    vocab 32000, d 4096, 32 layers, 32 / 8 heads, d_ff 14336, 8 experts,
    top-2, rope_theta 1e6, rms eps 1e-5, no sliding window, untied; the
    reference's default capacity factor 1.25; the flash kernel."""
    from nos_tpu_torch.models.llama import LlamaConfig

    shape = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 d_ff=14336, n_experts=8, moe_top_k=2, rope_theta=1e6, norm_eps=1e-5,
                 attention="flash")
    return LlamaConfig(**{**shape, **overrides})


def tied_routers(params):
    """The same tree with every router zero: each token's experts tie,
    so routing is [0, 1] for every token whatever the rounding upstream.
    Shares every other tensor with ``params``."""
    import torch

    return dict(params, layers=[
        dict(layer, moe=dict(layer["moe"], router=torch.zeros_like(layer["moe"]["router"])))
        for layer in params["layers"]])


def dense_moe_oracle(params, x, top_k):
    """A plain per-token MoE: each token's top-k experts by f32 router
    probability (renormalised), every expert applied densely to the
    tokens that chose it, no capacity."""
    import torch
    import torch.nn.functional as F

    flat = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(flat.float() @ params["router"], dim=-1)
    weight, expert = torch.topk(probs, top_k, dim=-1)
    weight = weight / weight.sum(dim=-1, keepdim=True)
    out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
    for e in range(params["router"].shape[1]):
        rows, slot = (expert == e).nonzero(as_tuple=True)
        h = flat[rows]
        y = (F.silu(h @ params["w_gate"][e]) * (h @ params["w_up"][e])) @ params["w_down"][e]
        out.index_add_(0, rows, y.float() * weight[rows, slot, None])
    return out.to(x.dtype).reshape(x.shape)


def rel_frobenius(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


def moe_check_phase(card) -> None:
    """moe_mlp at Mixtral width (bf16, [1, 1024] hidden states, two
    layers of random experts) against the dense per-token oracle at
    capacity factor 8 (nothing dropped); the pairs dropped at the
    default factor; a zero router's ties on the card; a tiny f32 MoE on
    the card against the CPU."""
    import torch

    from nos_tpu_torch.models import moe as tm

    cfg = mixtral_config()
    mc = cfg.moe_config()
    wide = dataclasses.replace(mc, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    flat = x.reshape(1024, cfg.d_model)
    layers = []
    with torch.no_grad():
        for _ in range(2):
            params = tm.init_moe_params(gen, mc)
            got = tm.moe_mlp(params, x, wide)
            want = dense_moe_oracle(params, x, cfg.moe_top_k)
            keep = tm._route(flat, params["router"], mc)[4]
            layers.append({"rel_frobenius_err": rel_frobenius(got, want),
                           "max_abs_err": float((got - want).abs().max()),
                           "dropped_pairs_default_factor": int((~keep).sum()),
                           "finite": bool(torch.isfinite(got).all())})
            del params, got, want
        tie_experts = tm._route(flat, torch.zeros((cfg.d_model, mc.n_experts), device="cuda"),
                                mc)[1]
        ties_ok = bool((tie_experts == torch.tensor([0, 1], device="cuda")).all())
        # tiny f32 MoE: the card against the CPU
        tiny = tm.MoeConfig(d_model=64, d_ff=128, n_experts=8, top_k=2, dtype=torch.float32)
        cpu_gen = torch.Generator().manual_seed(32)
        cpu_p = tm.init_moe_params(cpu_gen, tiny)
        cpu_x = torch.randn((2, 48, 64), generator=cpu_gen)
        card_p = {k: v.cuda() for k, v in cpu_p.items()}
        want_route = tm._route(cpu_x.reshape(96, 64), cpu_p["router"], tiny)
        got_route = tm._route(cpu_x.reshape(96, 64).cuda(), card_p["router"], tiny)
        same_routing = all(torch.equal(got_route[i].cpu(), want_route[i]) for i in (1, 3, 4))
        tiny_err = float((tm.moe_mlp(card_p, cpu_x.cuda(), tiny).cpu()
                          - tm.moe_mlp(cpu_p, cpu_x, tiny)).abs().max())
    row = {"phase": "moe_check", "config": "mixtral_8x7b", "hidden": [1, 1024],
           "capacity_factor_checked": 8.0, "capacity_factor_default": mc.capacity_factor,
           "capacity_default": tm.capacity_per_expert(1024, mc),
           "layers": layers, "rel_limit": 2e-2,
           "zero_router_experts_0_1": ties_ok, "tiny_same_routing": same_routing,
           "tiny_max_abs_err": tiny_err, "tiny_atol": 1e-5, "card": card}
    row["ok"] = (all(r["finite"] and r["rel_frobenius_err"] <= 2e-2 for r in layers)
                 and ties_ok and same_routing and tiny_err <= 1e-5)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"moe_mlp disagrees on the card: {row}")


def moe_train_grads_phase(card) -> dict:
    """llama_loss gradients of a 2-layer Mixtral-width model, [1, 1024],
    bf16: flash (the three kernels) against dense, held with tied
    routers. A random router's near-ties can route a token to another
    expert on the two paths (their bf16 attention rounds differently),
    which moves one token's share of the stacks' gradients: that run is
    reported beside it, not held."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = mixtral_config(n_layers=2)
    params = llama.init_llama_params(cfg, seed=41, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    held = flash_dense_grads(tied_routers(params), tokens, cfg)
    random_router = flash_dense_grads(params, tokens, cfg)
    with torch.no_grad():
        _, aux = llama.llama_forward(params, tokens, cfg, with_aux=True)
    row = {"phase": "moe_train_grads", "config": "mixtral_8x7b", "layers": 2,
           "tokens": [1, 1024], **held, "random_router": random_router,
           "aux_random_router": float(aux), "loss_limit": LOSS_LIMIT,
           "grad_rel_limit": GRAD_REL_LIMIT, "card": card}
    row["ok"] = grads_hold(held, cfg.n_layers) and bool(torch.isfinite(aux))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"MoE flash gradients disagree with dense: {row}")
    return row


def mixtral_int8_tree(cfg, seed=51):
    """The int8 serving tree of a random Mixtral, built one layer at a
    time (the bf16 tree, 93 GB, does not fit on the card): a one-layer
    model drawn from its own seed, quantized, its layer kept; embedding,
    lm_head and final norm come from the first draw."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import quantize_params

    one = dataclasses.replace(cfg, n_layers=1)
    tree = None
    for i in range(cfg.n_layers):
        q = quantize_params(llama.init_llama_params(one, seed=seed + i, device="cuda"))
        if tree is None:
            tree = q
        else:
            tree["layers"].append(q["layers"][0])
    return tree


def mixtral_int8_phase(card, ep_ref=None) -> dict:
    """Mixtral-8x7B at full width and depth in int8: conversion, the
    2-layer oracle check, flash against dense, generate(), one decode
    step beside its weight-read bound, the Engine, a lone request. With
    ``ep_ref`` (a directory) it also leaves there what the ep phases are
    held against: the flash logits of [1, EP_FORWARD_SEQ] seeded tokens
    (``logits.pt``) and generate()'s prompt and tokens (``serve.pt``)."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import quantize as tq
    from nos_tpu_torch.models.decode_bench import time_decode
    from nos_tpu_torch.serve import Engine, GenRequest

    cfg = mixtral_config()
    t_start = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tree = mixtral_int8_tree(cfg)
    torch.cuda.synchronize()
    wbytes = tq.weight_bytes(tree)
    emit({"phase": "mixtral_int8_convert", "config": "mixtral_8x7b", "weights": "int8",
          "layers": cfg.n_layers, "weight_bytes": wbytes, "seconds": time.time() - t0,
          "conversion_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "resident_gib": torch.cuda.memory_allocated() / 2**30, "card": card})
    tied = tied_routers(tree)
    gen = torch.Generator(device="cuda").manual_seed(52)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    checks = {}
    with torch.no_grad():
        # 2 layers: int8 against the fake-quant oracle (held tied, as above)
        two = dataclasses.replace(cfg, n_layers=2)
        for name, params in (("tied", tied), ("random_router", tree)):
            sliced = dict(params, layers=params["layers"][:2])
            got = llama.llama_forward(sliced, tokens, two)
            want = llama.llama_forward(tq.dequantize_params(sliced, cfg.dtype), tokens, two)
            checks[f"oracle_{name}"] = {
                "rel_frobenius_err": rel_frobenius(got, want),
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(got).all())}
            del got, want
        # full depth: flash against dense (held tied, the Llama phase's limits)
        for name, params in (("tied", tied), ("random_router", tree)):
            flash = llama.llama_forward(params, tokens, cfg)
            dense = llama.llama_forward(params, tokens, dataclasses.replace(cfg, attention="dense"))
            checks[f"flash_dense_{name}"] = logits_agreement(flash, dense)
            del flash, dense
        if ep_ref is not None:
            ep_tokens = torch.randint(0, cfg.vocab_size, (1, EP_FORWARD_SEQ),
                                      generator=torch.Generator(device="cuda").manual_seed(53),
                                      device="cuda")
            torch.save(llama.llama_forward(tree, ep_tokens, cfg).cpu(),
                       os.path.join(ep_ref, "logits.pt"))
            del ep_tokens
    oracle, fd = checks["oracle_tied"], checks["flash_dense_tied"]
    row = {"phase": "mixtral_int8_checks", "tokens": [1, 1024], **checks,
           "rel_limit": QUANT_REL_LIMIT["int8"], "card": card}
    row["ok"] = (oracle["finite"] and oracle["rel_frobenius_err"] <= QUANT_REL_LIMIT["int8"]
                 and logits_hold(fd))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral int8 checks failed: {row}")
    del tied

    # the main path: generate() with the launch counts zeroed just before
    with torch.no_grad():
        prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        out = gen_mod.generate(tree, prompt, cfg, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = counts()[0]
    row = {"phase": "mixtral_generate", "weights": "int8", "prompt": [2, 512],
           "new_tokens": 32, "flash_launches": launches, "seconds": wall,
           "tokens_per_s": 2 * 32 / wall, "card": card}
    row["ok"] = (tuple(out.shape) == (2, 32) and launches == cfg.n_layers
                 and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral generate() failed: {row}")
    if ep_ref is not None:
        torch.save({"prompt": prompt.cpu(), "generated": out.cpu()},
                   os.path.join(ep_ref, "serve.pt"))

    # the prefill alone, and one decode step at the generate shapes beside
    # the weight-read bound
    with torch.no_grad():
        t0 = time.perf_counter()
        gen_mod.prefill(tree, prompt, cfg, 544)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        ms, run = time_decode(tree, cfg, prompt, out[:, 0], False, steps=4, max_len=544)
        emit({"phase": "mixtral_decode_step", "weights": "int8", "batch": 2,
              "prefill_ms": prefill_ms, "cache_len": 544, "ms_per_step": ms,
              "weight_bytes": wbytes,
              "weight_read_bound_ms": wbytes / PEAK_HBM_BYTES_S * 1e3, "card": card})
        emit(profile_steps(run, card, ms, steps=2, phase="mixtral_decode_profile"))
        del run

    # the Engine: padded (20, 100) and chunked (300, 600) admission
    rng_tokens = torch.randint(1, cfg.vocab_size, (1020,), generator=gen,
                               device="cuda").tolist()
    prompts = [rng_tokens[:20], rng_tokens[20:120], rng_tokens[120:420], rng_tokens[420:]]

    def serve(reqs):
        eng = Engine(tree, cfg, max_slots=4, max_len=1024, prefill_chunk=256)
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in reqs]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.time() - t0

    results, wall = serve(prompts)
    row = {"phase": "mixtral_engine", "weights": "int8", "slots": 4,
           "requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
           "new_tokens": 32, "seconds": wall, "tokens_per_s": 32 * len(prompts) / wall,
           "card": card}
    row["ok"] = all(len(r) == 32 and all(0 <= t < cfg.vocab_size for t in r)
                    for r in results)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral engine failed: {row}")
    # a lone request in the 4-slot engine against a solo generate(): bf16
    # in other batch shapes and admission paths drifts, so only reported
    (lone,), lone_s = serve(prompts[1:2])
    with torch.no_grad():
        solo = gen_mod.generate(tree, torch.tensor([prompts[1]], device="cuda"), cfg,
                                max_new_tokens=32)[0].tolist()
    first_diff = next((i for i, (a, b) in enumerate(zip(lone, solo)) if a != b), 32)
    emit({"phase": "mixtral_engine_lone", "prompt_tokens": len(prompts[1]),
          "seconds": lone_s, "tokens_per_s": 32 / lone_s,
          "share_equal_to_solo_generate": sum(a == b for a, b in zip(lone, solo)) / 32,
          "tokens_before_first_divergence": first_diff,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "phase_seconds": time.time() - t_start, "card": card})
    return {"launches_generate": launches}


def profile_steps(run_steps, card, step_ms: float, steps: int = 8,
                  phase: str = "decode_profile") -> dict:
    """torch.profiler over ``run_steps(steps)``: device-busy time, the
    idle share of the wall time (profiled, and against the unprofiled
    ``step_ms``), kernel launches, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_steps(steps)
        wall_us = (time.time() - t0) * 1e6
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us, ev.count, ev.key))
    busy_us = sum(us for us, _, _ in kernels)
    copy_us = sum(us for us, _, key in kernels if "copy" in key.lower())
    kernels.sort(reverse=True)
    return {
        "phase": phase, "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        # dtype conversions and copies (the int8 -> bf16 widening among them)
        "copy_kernels_ms_per_step": copy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_idle_share_unprofiled": 1.0 - busy_us / steps / 1e3 / step_ms,
        "kernel_launches_per_step": sum(n for _, n, _ in kernels) / steps,
        "top_kernels": [{"name": k[:80], "ms_per_step": us / steps / 1e3,
                         "launches_per_step": n / steps}
                        for us, n, k in kernels[:12]],
        "card": card,
    }


# ---------------------------------------------------------------- sp paths
# Sequence- and data-parallel ranks run as processes on the one card, in a
# gloo group: NCCL refuses two ranks on one device. Their collectives
# stage device tensors through pinned host memory, so any time that
# crosses a hop measures that staging (and the ranks time-share the
# card), never a ring on NVLink.
SP_RING_SEQ = 16384      # Llama-3-8B's attention heads, sp 2 and 4
SP_GEMMA_SEQ = 8192      # Gemma-2B's heads (hd 256, one kv head), sp 2
SP_WINDOW = 4096
SP_FORWARD_SEQ = 8192    # Llama-3-8B at full depth, sp 2
# Four replicas of weights, gradients and velocity (6 bytes a parameter)
# plus each rank's activations: at 8 layers (2.01 B parameters) a rank
# peaks at 15.75 GiB and the card kept 6.3 and 1.6 GiB free after the
# step in two runs of this phase (NVIDIA H100 80GB HBM3, 700 W). 4 layers
# (6 until the expert and pipeline phases joined the script) keep the
# script inside its time budget.
SP_TRAIN_LAYERS = 4
SP_TRAIN_TOKENS = (2, 4096)
# One step from zero velocity moves each weight by lr * g. At lr 1e4 every
# update outgrows the weight it moves, so the bf16 parameter delta carries
# the gradient to bf16's relative precision (2^-8) and not to the weight's
# spacing, which at lr 1.0 swamps it (4-36% apart per leaf kind where the
# velocities stood 2% apart, 8 layers on an NVIDIA H100 80GB HBM3, 700 W).
# The step's work is the same at any lr; the loss is taken before the
# update.
SP_TRAIN_LR = 1e4
# the sp train step against the one-device step: the loss, and each leaf
# kind's gradient, read from the velocity (v = g after one step from zero)
# and recovered from the parameter delta, as max |g_mesh - g_one| over the
# kind's largest |g_one|
SP_LOSS_LIMIT = 2e-3
SP_GRAD_REL_LIMIT = 3e-2


def sp_spawn(world: int, plan, card) -> list:
    """Run ``plan``, a list of (function name, kwargs), on ``world`` ranks
    spawned on cuda:0 in one gloo group; each rank's list of rows, in
    plan order. A rank that raises fails the call (and the script)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="nos-sp-")
    try:
        mp.spawn(sp_rank, args=(world, work, card, plan), nprocs=world)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks


def sp_rank(rank, world, work, card, plan) -> None:
    """One spawned rank: joins the gloo group, runs the plan, writes its
    rows for the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        rows = []
        for name, kwargs in plan:
            rows.append(globals()[name](rank, world, card, **kwargs))
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def sp_fail(row, what: str):
    raise RuntimeError(f"{what} failed on rank {row.get('rank')}: {json.dumps(row)}")


def grads_close(got, want) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= BWD_ATOL + BWD_RTOL * want.abs()).all()
                and torch_isfinite(got))


def torch_isfinite(x) -> bool:
    import torch

    return bool(torch.isfinite(x).all())


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of ``fn`` (the card synchronized after each
    call) over ``reps`` runs after one warm-up: for calls that block the
    host, such as a gloo exchange. Every rank of a collective calls it the
    same number of times."""
    import statistics

    import torch

    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def block_against_plain(q, k, v, do, q_off, kv_off, window) -> dict:
    """One ring block's kernels against their plain versions on the same
    inputs, as the ring calls them: flash_attention_block against
    flash_attention_reference (O_ATOL, LSE_ATOL), and flash_block_grads
    with f32 outputs and ``delta`` passed in against
    flash_attention_bwd_reference (BWD_ATOL + BWD_RTOL |want|)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa

    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, window=window)
    want, want_lse = fa.flash_attention_reference(q, k, v, q_off, kv_off, window=window)
    kw = dict(window=window, grad_dtype=torch.float32, delta=fa.flash_delta(do, out))
    got = fa.flash_block_grads(q, k, v, out, lse, do, q_off, kv_off, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off, kv_off, **kw)
    fin = torch.isfinite(want_lse)
    row = {"q_off": q_off, "kv_off": kv_off,
           "o_max_abs_err": float((out.float() - want.float()).abs().max()),
           "lse_max_abs_err": float((lse[fin] - want_lse[fin]).abs().max()) if fin.any()
           else 0.0,
           "neg_inf_rows_match": bool(torch.equal(torch.isneginf(lse),
                                                  torch.isneginf(want_lse))),
           "grad_dtype": "f32",
           **{f"{g}_max_abs_err": float((a - b).abs().max())
              for g, a, b in zip(("dq", "dk", "dv"), got, ref)}}
    row["ok"] = (row["o_max_abs_err"] <= O_ATOL and row["lse_max_abs_err"] <= LSE_ATOL
                 and row["neg_inf_rows_match"] and torch_isfinite(out.float())
                 and all(a.dtype == torch.float32 and grads_close(a, b)
                         for a, b in zip(got, ref)))
    return row


def sp_ring_case(rank, world, card, case, s, hq, hkv, hd, window=None,
                 strategy="ring") -> dict:
    """This rank's ring_flash_attention (or Ulysses through flash_attention)
    over ``world`` sp ranks, output and dQ/dK/dV against the one-process
    flash_attention forward and backward on the whole sequence; launches
    counted around the sp call alone; then, one rank at a time while the
    others wait, each of its hops' kernels timed at the ring's shapes and
    offsets (rank 0 also times the whole-sequence kernels); on the ring,
    the last rank also holds its diagonal block's kernels and its nearest
    other block's against their plain versions (``block_against_plain``),
    each rank times the host staging of one hop's K/V alone, and then all
    ranks time one shift together with no kernel running."""
    import torch
    import torch.distributed as dist

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.ring_attention import ring_flash_attention
    from nos_tpu_torch.parallel.ulysses import ulysses_attention
    from nos_tpu_torch.util.cuda_timing import event_ms

    mesh = pm.mesh_from_devices((1, world), ("dp", "sp"))
    gen = torch.Generator(device="cuda").manual_seed(s + hd + (window or 0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(1, s, hq, hd), randn(1, s, hkv, hd), randn(1, s, hkv, hd), \
        randn(1, s, hq, hd)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = fa.flash_attention(*leaves, window=window)
    wdq, wdk, wdv = torch.autograd.grad(want, leaves, do)
    n = s // world
    rows = slice(rank * n, (rank + 1) * n)
    local = [x[:, rows].contiguous().requires_grad_(True) for x in (q, k, v)]
    d_local = do[:, rows].contiguous()
    if strategy == "ring":
        fn = ring_flash_attention
        blocks = [(rank - i) % world for i in range(world)
                  if visible_pairs(n, n, rank * n, ((rank - i) % world) * n, True, window)]
        expect = [len(blocks)] * 3
    else:
        fn = functools.partial(ulysses_attention, attention="flash")
        blocks, expect = [], [1, 1, 1]
    torch.cuda.synchronize()
    dist.barrier()
    zero_counts()  # the sp path: every launch from here to the read is its own
    t0 = time.perf_counter()
    out = fn(*local, mesh, window=window)
    torch.cuda.synchronize()
    fwd_wall = (time.perf_counter() - t0) * 1e3
    fwd_launches = counts()
    zero_counts()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(out, local, d_local.reshape(out.shape))
    torch.cuda.synchronize()
    bwd_wall = (time.perf_counter() - t0) * 1e3
    bwd_launches = counts()
    got, want = out.detach().reshape(1, n, hq, hd), want.detach()
    o_err = float((got.float() - want[:, rows].float()).abs().max())
    errs = {g: float((a.float() - b[:, rows].float()).abs().max())
            for g, a, b in zip(("dq", "dk", "dv"), grads, (wdq, wdk, wdv))}
    close = all(grads_close(a, b[:, rows]) for a, b in zip(grads, (wdq, wdk, wdv)))
    launches = [fwd_launches[0], bwd_launches[1], bwd_launches[2]]
    row = {"phase": "sp_ring_kernels", "case": case, "strategy": strategy, "rank": rank,
           "sp": world, "shape": {"b": 1, "s": s, "s_rank": n, "hq": hq, "hkv": hkv,
                                  "hd": hd},
           "window": window, "transport": comm.transport(mesh.get_group("sp"), "cuda"),
           "kv_blocks_run": blocks, "launches_fwd_dq_dkv": launches,
           "expected_launches": expect,
           "stray_launches": [fwd_launches[1], fwd_launches[2], bwd_launches[0]],
           "o_max_abs_err": o_err, **{f"{g}_max_abs_err": e for g, e in errs.items()},
           "o_atol": O_ATOL, "atol": BWD_ATOL, "rtol": BWD_RTOL,
           "fwd_wall_ms_gloo_host_staged": fwd_wall,
           "bwd_wall_ms_gloo_host_staged": bwd_wall, "card": card}
    row["ok"] = (o_err <= O_ATOL and close and torch_isfinite(got)
                 and launches == expect and row["stray_launches"] == [0, 0, 0])
    if not row["ok"]:
        sp_fail(row, f"sp ring case {case}")
    # each hop's kernels alone, one rank at a time (the others wait)
    hops, whole, plain, staging = [], None, [], None
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        q_loc = local[0].detach()
        for j in blocks:
            kb, vb = k[:, j * n:(j + 1) * n].contiguous(), v[:, j * n:(j + 1) * n].contiguous()
            offs = (rank * n, j * n)
            o_b, lse_b = fa.flash_attention_block(q_loc, kb, vb, *offs, window=window)
            args = (q_loc, kb, vb, lse_b, d_local, fa.flash_delta(d_local, o_b), *offs,
                    True, window, torch.float32)
            pairs = visible_pairs(n, n, *offs, True, window)
            hops.append({
                "kv_block": j, "q_off": offs[0], "kv_off": offs[1],
                "pairs_per_head": pairs,
                "fwd_ms": event_ms(lambda: fa.flash_attention_block(
                    q_loc, kb, vb, *offs, window=window)),
                "dq_f32_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, True, False)),
                "dkv_f32_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, False, True)),
                "fwd_bound_ms": attention_bound_ms(1, n, n, hq, hkv, hd, pairs)[0],
            })
            if rank == world - 1 and j in blocks[:2]:  # the diagonal, the nearest other
                plain.append(block_against_plain(q_loc, kb, vb, d_local, *offs, window))
        if blocks:
            staging = hop_staging_ms(local[1].detach(), local[2].detach())
        if rank == 0 and strategy == "ring":
            qd, kd, vd = (x.detach() for x in (q, k, v))
            o_w, lse_w = fa.flash_attention_block(qd, kd, vd, 0, 0, window=window)
            args = (qd, kd, vd, lse_w, do, fa.flash_delta(do, o_w), 0, 0, True, window, None)
            whole = {"pairs_per_head": visible_pairs(s, s, 0, 0, True, window),
                     "fwd_ms": event_ms(lambda: fa.flash_attention_block(
                         qd, kd, vd, 0, 0, window=window), reps=5),
                     "dq_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, True, False), reps=5),
                     "dkv_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, False, True), reps=5)}
    dist.barrier()
    row["hops_alone"] = hops
    if whole is not None:
        row["whole_sequence_one_process"] = whole
    if strategy == "ring":
        group = mesh.get_group("sp")
        kv = [local[1].detach(), local[2].detach()]
        row["hop_staging_alone_ms"] = staging
        # every rank shifts at once, as in the ring, with no kernel running
        row["shift_all_ranks_no_kernels_ms_gloo_host_staged"] = wall_ms(
            lambda: comm.ring_shift(kv, group))
        row["blocks_against_plain"] = plain
        if rank == world - 1 and (len(plain) != min(2, len(blocks))
                                  or not all(p["ok"] for p in plain)):
            sp_fail(row, f"sp ring case {case}: a block's kernels against plain")
    return row


def hop_staging_ms(k, v) -> dict:
    """What one forward hop's K/V costs a rank before and after gloo moves
    it, timed with no other rank using the card: packing both into one
    buffer on the card, its copy into pinned host memory and the copy
    back (comm.ring_shift's staging)."""
    import torch

    from nos_tpu_torch.parallel import comm

    packed = comm._pack([k, v])
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    return {"bytes": packed.numel(),
            "pack_ms": wall_ms(lambda: comm._pack([k, v])),
            "to_pinned_host_ms": wall_ms(lambda: host.copy_(packed)),
            "from_pinned_host_ms": wall_ms(lambda: host.to(k.device))}


def sp_forward_case(rank, world, card, seq) -> dict:
    """Llama-3-8B at full width and depth (random weights from a seed,
    bf16, flash): llama_forward over an sp mesh on this rank's [1, seq/sp]
    block against the one-device flash forward on the whole [1, seq]."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=31, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((1, world), ("dp", "sp"))
    n = seq // world
    blocks = sum(1 for j in range(world) if visible_pairs(n, n, rank * n, j * n, True, None))
    with torch.no_grad():
        want = llama.llama_forward(params, tokens, cfg)[:, rank * n:(rank + 1) * n].clone()
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()  # the sp path
        t0 = time.perf_counter()
        got = llama.llama_forward(params, llama_data_sharding(mesh, tokens), cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
        stats = logits_agreement(got, want)
    from nos_tpu_torch.parallel.comm import transport

    row = {"phase": "sp_forward", "config": "llama_3_8b", "rank": rank, "sp": world,
           "transport": transport(mesh.get_group("sp"), "cuda"),
           "tokens": [1, seq], "tokens_rank": [1, n], "layers": cfg.n_layers,
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [blocks * cfg.n_layers, 0, 0], **stats,
           "rel_limit": FWD_REL_LIMIT, "probs_limit": FWD_PROB_LIMIT,
           "argmax_limit": FWD_ARGMAX_LIMIT, "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    row["ok"] = list(launches) == row["expected_launches"] and logits_hold(stats)
    if not row["ok"]:
        sp_fail(row, "sp_forward")
    return row


def mesh_against_one_device(state, loss: float, ref, mesh, lr: float) -> dict:
    """A mesh step's state against the one-device step's (``ref``, on rank
    0: its loss, and host copies of the initial params, the updated params
    and the velocity), leaf by leaf: each shard gathered whole over the
    mesh (a collective: every rank calls this), then on rank 0 each leaf
    kind's gradient read from the velocity and recovered from the
    parameter delta, as max |g_mesh - g_one| over the kind's largest
    |g_one|. The gathered velocity's checksum, the same on every rank,
    shows the ranks' shards make one state. A function of its own, so its
    device temporaries are gone before the next mesh's step."""
    import torch

    from nos_tpu_torch.models.llama import tree_leaves
    from nos_tpu_torch.parallel.sharding import gather_shard, rule_leaves, tree_rules

    g_diff, g_ref, d_diff, d_ref = {}, {}, {}, {}
    specs = rule_leaves(tree_rules(state[0], mesh))
    checksum, finite = 0.0, True
    for i, ((kind, p1), v, spec) in enumerate(zip(named_leaves(state[0]),
                                                  tree_leaves(state[1]), specs)):
        v = gather_shard(v, spec, mesh)
        p1 = gather_shard(p1.detach(), spec, mesh)
        checksum += float(v.double().sum())
        finite = finite and bool(torch.isfinite(v).all())
        if ref is None:
            continue
        v_ref = ref["v"][i].cuda().float()
        g_diff[kind] = max(g_diff.get(kind, 0.0), float((v.float() - v_ref).abs().max()))
        g_ref[kind] = max(g_ref.get(kind, 0.0), float(v_ref.abs().max()))
        p0 = ref["p0"][i].cuda().float()
        delta = (p0 - p1.float()) / lr
        delta_ref = (p0 - ref["p1"][i].cuda().float()) / lr
        d_diff[kind] = max(d_diff.get(kind, 0.0), float((delta - delta_ref).abs().max()))
        d_ref[kind] = max(d_ref.get(kind, 0.0), float(delta_ref.abs().max()))
    out = {"velocity_checksum": checksum, "finite": finite}
    if ref is not None:
        out.update({"one_device_loss": ref["loss"], "one_device_step_ms": ref["ms"],
                    "loss_abs_diff": abs(loss - ref["loss"]),
                    "grad_rel_err": {k: g_diff[k] / g_ref[k] for k in g_diff},
                    "grad_from_param_delta_rel_err": {
                        k: d_diff[k] / d_ref[k] if d_ref[k] else None for k in d_diff}})
    return out


def one_device_step(cfg, tokens, seed, lr) -> dict:
    """The one-device make_train_step(None) step (no remat) from the
    params of ``seed``: its loss and ms, and host copies of the initial
    params, the updated params and the velocity."""
    import torch

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    step, shard = make_train_step(None, cfg, learning_rate=lr)
    state = shard(llama.init_llama_params(cfg, seed=seed, device="cuda"), donate=True)
    p0 = [p.detach().to("cpu", copy=True) for p in llama.tree_leaves(state[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, tokens)
    torch.cuda.synchronize()
    ref = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3, "p0": p0,
           "p1": [p.detach().cpu() for p in llama.tree_leaves(state[0])],
           "v": [x.cpu() for x in llama.tree_leaves(state[1])]}
    del state
    torch.cuda.empty_cache()
    return ref


def held_to_one_device(row, limit_loss: float) -> bool:
    from_delta = list(row["grad_from_param_delta_rel_err"].values())
    return (row["finite"] and row["loss_abs_diff"] <= limit_loss
            and max(row["grad_rel_err"].values()) <= SP_GRAD_REL_LIMIT
            and None not in from_delta and max(from_delta) <= SP_GRAD_REL_LIMIT)


def sp_train_case(rank, world, card, layers, tokens_shape, meshes) -> list:
    """Llama-3-8B at full width and ``layers`` deep (bf16, flash), one
    momentum-SGD step from zero velocity on each ``(dp, sp, remat)`` of
    ``meshes`` against the one-device make_train_step(None) step (no
    remat) on the same tokens and initial params (rank 0 runs it first,
    alone): the loss, each leaf kind's gradient read from the velocity
    (v = g after one step from zero) and the one recovered from the
    parameter delta, the launches of the sp step, the replicas' agreement.
    With remat each block's backward first replays its forward, ring
    shifts and ring kernels included, so the forward kernel runs twice.
    The gradient sum over the mesh (host-staged) is timed apart from the
    rest of the step."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding
    from nos_tpu_torch.parallel.sp_bench import timed_grad_sum

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 41, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    rows = []
    for *dims, remat in meshes:
        mesh = pm.mesh_from_devices(tuple(dims), ("dp", "sp"))
        sp_idx = pm.axis_index(mesh, "sp")
        n = tokens_shape[1] // dims[1]
        blocks = sum(1 for j in range(dims[1])
                     if visible_pairs(n, n, sp_idx * n, j * n, True, None))
        step, shard = make_train_step(mesh, dataclasses.replace(cfg, remat=remat),
                                      learning_rate=SP_TRAIN_LR)
        state = shard(llama.init_llama_params(cfg, seed=41, device="cuda"), donate=True)
        block = llama_data_sharding(mesh, tokens).contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        zero_counts()  # the sp path
        with timed_grad_sum() as sum_ms:
            t0 = time.perf_counter()
            state, loss = step(state, block)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
        compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
        sums = [None] * world
        dist.all_gather_object(sums, compared.pop("velocity_checksum"))
        row = {"phase": "sp_train", "config": "llama_3_8b", "layers": layers,
               "mesh": {"dp": dims[0], "sp": dims[1]}, "remat": remat, "rank": rank,
               "transport": comm.transport(mesh.get_group("sp"), "cuda"),
               "tokens": list(tokens_shape), "tokens_rank": list(block.shape),
               "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
               "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
               "expected_launches": [(2 if remat else 1) * blocks * layers,
                                     blocks * layers, blocks * layers],
               "replicas_agree": len(set(sums)) == 1,
               "step_wall_ms_gloo_host_staged": wall,
               "grad_sum_ms_gloo_host_staged": sum(sum_ms),
               "step_without_grad_sum_ms": wall - sum(sum_ms),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "card_free_gib_after_step": torch.cuda.mem_get_info()[0] / 2**30,
               "card": card}
        row.update(compared)
        ok = row["replicas_agree"] and list(launches) == row["expected_launches"]
        if rank == 0:
            row["grad_rel_limit"] = SP_GRAD_REL_LIMIT
            row["loss_limit"] = SP_LOSS_LIMIT
            ok = ok and held_to_one_device(row, SP_LOSS_LIMIT)
        row["ok"] = ok
        if not ok:
            sp_fail(row, f"sp_train {dims}")
        rows.append(row)
        del state
        torch.cuda.empty_cache()
        dist.barrier()
    return rows


def sp_phases(card) -> dict:
    """The three sp phases on spawned ranks: sp_ring_kernels (Llama-3-8B's
    attention at S 16384, sp 2 and 4, causal and a 4096 window; Gemma-2B's
    heads at S 8192, sp 2; Ulysses at sp 4), sp_forward (Llama-3-8B at full
    depth, sp 2, [1, 8192]) and sp_train (SP_TRAIN_LAYERS layers at full
    width, dp 1 x sp 4, and dp 2 x sp 2 with remat). Two spawns: the sp-2 work on two
    ranks, the sp-4 work on four. The kernels are built already (the ranks
    load them), and the parent holds no card memory of its own."""
    import torch

    torch.cuda.empty_cache()
    emit({"phase": "sp_spawn", "parent_gib_allocated": torch.cuda.memory_allocated() / 2**30,
          "parent_gib_reserved": torch.cuda.memory_reserved() / 2**30, "card": card})
    llama_heads = dict(hq=32, hkv=8, hd=128)
    t0 = time.time()
    two = sp_spawn(2, [
        ("sp_ring_case", dict(case="llama_causal_sp2", s=SP_RING_SEQ, **llama_heads)),
        ("sp_ring_case", dict(case="llama_window4096_sp2", s=SP_RING_SEQ,
                              window=SP_WINDOW, **llama_heads)),
        ("sp_ring_case", dict(case="gemma_hd256_causal_sp2", s=SP_GEMMA_SEQ, hq=8, hkv=1,
                              hd=256)),
        ("sp_forward_case", dict(seq=SP_FORWARD_SEQ)),
    ], card)
    t_two = time.time() - t0
    t0 = time.time()
    four = sp_spawn(4, [
        ("sp_ring_case", dict(case="llama_causal_sp4", s=SP_RING_SEQ, **llama_heads)),
        ("sp_ring_case", dict(case="llama_window4096_sp4", s=SP_RING_SEQ,
                              window=SP_WINDOW, **llama_heads)),
        ("sp_ring_case", dict(case="ulysses_llama_causal_sp4", s=SP_RING_SEQ,
                              strategy="ulysses", **llama_heads)),
        ("sp_train_case", dict(layers=SP_TRAIN_LAYERS, tokens_shape=SP_TRAIN_TOKENS,
                               meshes=[(1, 4, False), (2, 2, True)])),
    ], card)
    t_four = time.time() - t0
    ring_rows = [rows[i] for i in range(3) for rows in two] + \
        [rows[i] for i in range(3) for rows in four]
    for row in ring_rows:
        emit(row)
    forward_rows = [rows[3] for rows in two]
    for row in forward_rows:
        emit(row)
    train_rows = [rows[3][i] for i in range(2) for rows in four]
    for row in train_rows:
        emit(row)
    emit({"phase": "sp_phases", "seconds_two_ranks": t_two, "seconds_four_ranks": t_four,
          "card": card})
    launches = {f"sp_ring_kernels.{row['case']}": [] for row in ring_rows}
    for row in ring_rows:
        launches[f"sp_ring_kernels.{row['case']}"].append(row["launches_fwd_dq_dkv"])
    launches["sp_forward"] = [row["launches_fwd_dq_dkv"] for row in forward_rows]
    for row in train_rows:
        key = f"sp_train.dp{row['mesh']['dp']}_sp{row['mesh']['sp']}" + (
            "_remat" if row["remat"] else "")
        launches.setdefault(key, []).append(row["launches_fwd_dq_dkv"])
    return {"launches": launches, "ring": ring_rows}


# Tensor parallelism and FSDP, on ranks sharing the card over gloo
TP_FORWARD_SEQ = 2048    # Llama-3-8B at full depth, tp 2 (Hq 16, Hkv 4 a rank)
TP4_FORWARD_LAYERS = 4   # tp 4 (Hq 8, Hkv 2): four ranks each init the whole tree
TP_ENGINE_NEW = 16       # tokens a request, four requests
TP_TRAIN_LAYERS = 4
TP_TRAIN_TOKENS = (4, 2048)
TP_LOSS_LIMIT = 1e-3


def local_heads(shards, cfg) -> list:
    """The rank's (query, kv) heads, read off its wq / wk shards."""
    layer = shards["layers"][0]

    def columns(leaf):
        return (leaf if hasattr(leaf, "shape") else leaf.q).shape[-1]

    return [columns(layer["wq"]) // cfg.head_dim, columns(layer["wk"]) // cfg.head_dim]


def same_on_every_rank(value, world: int) -> bool:
    import torch.distributed as dist

    got = [None] * world
    dist.all_gather_object(got, value)
    return all(g == got[0] for g in got)


def tp_forward_case(rank, world, card, seq, layers=None) -> dict:
    """Llama-3-8B at full width (``layers`` deep; all 32 by default,
    random weights from a seed, bf16, flash): llama_forward over a
    ``('tp',)`` mesh of ``world`` ranks on [1, seq], each rank on its
    shards (its n_heads/tp and n_kv_heads/tp heads), against the
    one-device flash forward of the whole tree (rank 0) under
    forward_check's limits; the forward kernel's launches on each rank
    (one a layer at the local heads), the gathered logits the same bytes
    on every rank."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash",
                              **({"n_layers": layers} if layers else {}))
    params = llama.init_llama_params(cfg, seed=61, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(61)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((world,), ("tp",))
    with torch.no_grad():
        want = llama.llama_forward(params, tokens, cfg) if rank == 0 else None
        shards = shard_params(params, mesh, cfg)
        del params
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()  # the tp path
        t0 = time.perf_counter()
        got = llama.llama_forward(shards, tokens, cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "tp_forward", "config": "llama_3_8b", "rank": rank, "tp": world,
           "layers": cfg.n_layers, "tokens": [1, seq],
           "transport": comm.transport(mesh.get_group("tp"), "cuda"),
           "local_heads_q_kv": local_heads(shards, cfg),
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [cfg.n_layers, 0, 0],
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "weight_bytes_rank": weight_bytes(shards),
           "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = (list(launches) == row["expected_launches"] and row["same_logits_every_rank"]
          and row["local_heads_q_kv"] == [cfg.n_heads // world, cfg.n_kv_heads // world])
    if rank == 0:
        stats = logits_agreement(got, want)
        row.update(stats, rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
    row["ok"] = ok
    if not ok:
        sp_fail(row, f"tp_forward tp {world}")
    return row


def serve_requests(tree, cfg, prompts, new_tokens, mesh=None) -> dict:
    """An Engine (4 slots, max_len 512, 256-token pieces) over ``tree``
    answering ``prompts``: completions in submit order, seconds, and the
    engine's weight and cache bytes on this rank."""
    import torch

    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.serve import Engine, GenRequest

    eng = Engine(tree, cfg, max_slots=4, max_len=512, prefill_chunk=256, mesh=mesh)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=new_tokens)) for p in prompts]
        got = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    cache = sum(t.numel() * t.element_size() for layer in eng._cache for t in layer.values())
    return {"tokens": [got[i] for i in ids], "seconds": seconds,
            "weight_bytes": weight_bytes(tree), "cache_bytes": cache,
            "cache_heads": eng._cache[0]["k"].shape[2]}


def first_token_held(tokens, first_probs) -> list:
    """Per request: its first token is the one-device argmax, or within
    FWD_PROB_LIMIT of the argmax's probability there (a near tie that
    bf16 summation order may break either way)."""
    return [bool(p[t[0]] >= p.max() - FWD_PROB_LIMIT) for t, p in zip(tokens, first_probs)]


def agreement(got, want) -> float:
    pairs = [(a, b) for x, y in zip(got, want) for a, b in zip(x, y)]
    return sum(a == b for a, b in pairs) / len(pairs)


def tp_engine_case(rank, world, card, new_tokens) -> list:
    """Llama-3-8B at full width and depth (bf16, flash) served over a
    ``('tp',)`` mesh of ``world`` ranks: greedy generate() on [2, 512]
    (its unpadded prefill launches the forward kernel once a layer at the
    local heads) and an Engine over the head-sharded cache answering four
    requests (padded and chunked admission), then the same Engine over
    the int8 tree through shard_for_serving. Every rank's completions are
    the same; against the one-device Engine (rank 0) the share of equal
    tokens is reported, bf16 summation order differing, and each
    request's first token is held (the one-device argmax or a near tie)."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import quantize_params
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.serve import shard_for_serving

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=63, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(63)
    pool = torch.randint(1, cfg.vocab_size, (700,), generator=gen, device="cuda").tolist()
    prompts = [pool[:20], pool[20:120], pool[120:320], pool[320:620]]
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((world,), ("tp",))
    one, first_probs = {}, None
    if rank == 0:
        with torch.no_grad():
            one["generate"] = gen_mod.generate(params, prompt, cfg, new_tokens).tolist()
            first_probs = [torch.softmax(gen_mod.prefill(
                params, torch.tensor([p], device="cuda"), cfg, len(p))[0][0, -1], -1).cpu()
                for p in prompts]
        one["bf16"] = serve_requests(params, cfg, prompts, new_tokens)
    dist.barrier()
    q8 = quantize_params(params)
    if rank == 0:
        one["int8"] = serve_requests(q8, cfg, prompts, new_tokens)
    dist.barrier()
    trees = {"int8": shard_for_serving(q8, mesh, cfg)}
    del q8
    trees["bf16"] = shard_for_serving(params, mesh, cfg)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    with torch.no_grad():
        zero_counts()  # the tp serving path
        t0 = time.perf_counter()
        out = gen_mod.generate(trees["bf16"], prompt, cfg, new_tokens, mesh=mesh).tolist()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = counts()
    rows = [{"phase": "tp_generate", "config": "llama_3_8b", "rank": rank, "tp": world,
             "prompt": [2, 512], "new_tokens": new_tokens,
             "local_heads_q_kv": local_heads(trees["bf16"], cfg),
             "launches_fwd_dq_dkv": list(launches),
             "expected_launches": [cfg.n_layers, 0, 0],
             "same_tokens_every_rank": same_on_every_rank(out, world),
             "seconds_gloo_host_staged": gen_s, "card": card}]
    for fmt in ("bf16", "int8"):
        dist.barrier()
        got = serve_requests(trees[fmt], cfg, prompts, new_tokens, mesh)
        rows.append({"phase": "tp_engine", "config": "llama_3_8b", "format": fmt,
                     "rank": rank, "tp": world, "requests": len(prompts),
                     "prompt_tokens": [len(p) for p in prompts], "new_tokens": new_tokens,
                     "same_tokens_every_rank": same_on_every_rank(got["tokens"], world),
                     "seconds_gloo_host_staged": got["seconds"],
                     "weight_bytes_rank": got["weight_bytes"],
                     "cache_bytes_rank": got["cache_bytes"],
                     "cache_heads_rank": got["cache_heads"], "card": card})
        if rank == 0:
            rows[-1].update(
                one_device_seconds=one[fmt]["seconds"],
                one_device_weight_bytes=one[fmt]["weight_bytes"],
                one_device_cache_bytes=one[fmt]["cache_bytes"],
                token_agreement_with_one_device=agreement(got["tokens"], one[fmt]["tokens"]),
                first_token_equal=[a[0] == b[0] for a, b in
                                   zip(got["tokens"], one[fmt]["tokens"])])
            if fmt == "bf16":
                rows[-1]["first_token_held"] = first_token_held(got["tokens"], first_probs)
        rows[-1]["tokens_ok"] = all(len(seq) == new_tokens and all(
            0 <= t < cfg.vocab_size for t in seq) for seq in got["tokens"])
    if rank == 0:
        rows[0]["token_agreement_with_one_device"] = agreement(out, one["generate"])
    ok = (list(launches) == rows[0]["expected_launches"]
          and rows[0]["same_tokens_every_rank"]
          and rows[0]["local_heads_q_kv"] == [cfg.n_heads // world, cfg.n_kv_heads // world]
          and all(r["same_tokens_every_rank"] and r["tokens_ok"]
                  and r["cache_heads_rank"] == cfg.n_kv_heads // world
                  and all(r.get("first_token_held", [True])) for r in rows[1:]))
    for r in rows:
        r["ok"] = ok
    if not ok:
        sp_fail(rows[0], f"tp_engine: {json.dumps(rows)}")
    return rows


def tp_train_case(rank, world, card, layers, tokens_shape, ckpt_dir) -> list:
    """Llama-3-8B at full width and ``layers`` deep (bf16, flash): one
    momentum-SGD step from zero velocity on a ``('dp', 'tp')`` 2 x 2 mesh
    with FSDP and remat, against the one-device make_train_step(None) step
    (rank 0 runs it first, alone) under the sp_train bars (the loss within
    TP_LOSS_LIMIT); the launches of each kernel (forward 2·L with the
    replay, dQ L, dK/dV L); the rank's param bytes and peak; the step's
    host wall time split by the collectives' kinds (timed_collectives: tp
    all-reduces and gathers, FSDP gathers and reduce-scatters, the
    gradient sum) and a second step without the split. Then the
    checkpoint: the state saved (DTensor shards staged on the host),
    restored onto a ('tp',) mesh of 4 and onto one device (rank 0), every
    leaf gathered whole and held bit-identical to the saved one; save and
    restore seconds and bytes."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(71)
    tokens = torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 71, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "tp"))
    remat_cfg = dataclasses.replace(cfg, remat=True)
    step, shard = make_train_step(mesh, remat_cfg, learning_rate=SP_TRAIN_LR)
    state = shard(llama.init_llama_params(cfg, seed=71, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    leaves = llama.tree_leaves(state[0])
    param_bytes = sum(p.numel() * p.element_size() for p in leaves)
    replicated = sum(p.numel() * p.element_size() for p in leaves if p.dim() == 1)
    block = llama_data_sharding(mesh, tokens).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the tp x FSDP training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        state, loss = step(state, block)
        torch.cuda.synchronize()
        wall_split = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
    agree = same_on_every_rank(compared.pop("velocity_checksum"), world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    row = {"phase": "tp_train", "config": "llama_3_8b", "layers": layers,
           "mesh": {"dp": 2, "tp": 2}, "fsdp": True, "remat": True, "rank": rank,
           "transport": comm.transport(mesh.get_group("tp"), "cuda"),
           "tokens": list(tokens_shape), "tokens_rank": list(block.shape),
           "local_heads_q_kv": local_heads(state[0], cfg),
           "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
           "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * layers, layers, layers],
           "replicas_agree": agree, "param_bytes_rank": param_bytes,
           "replicated_bytes_rank": replicated, "peak_gib": peak,
           "step_ms_with_split_gloo_host_staged": wall_split,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall_split - sum(collective_ms.values()), **compared,
           "card_free_gib_after_step": torch.cuda.mem_get_info()[0] / 2**30, "card": card}
    dist.barrier()
    t0 = time.perf_counter()
    state, loss2 = step(state, block)
    torch.cuda.synchronize()
    row["second_step_ms_gloo_host_staged"] = (time.perf_counter() - t0) * 1e3
    row["second_step_loss"] = float(loss2)
    ok = (agree and list(launches) == row["expected_launches"]
          and row["local_heads_q_kv"] == [cfg.n_heads // 2, cfg.n_kv_heads // 2])
    if rank == 0:
        whole = sum(2 * math.prod(p.shape) for p in ref["p0"])
        row.update(param_bytes_whole=whole, grad_rel_limit=SP_GRAD_REL_LIMIT,
                   loss_limit=TP_LOSS_LIMIT)
        ok = ok and held_to_one_device(row, TP_LOSS_LIMIT) and \
            param_bytes <= whole / 4 + replicated
        del ref
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_train")
    rows = [row, tp_checkpoint(rank, world, card, state, mesh, remat_cfg, ckpt_dir)]
    return rows


def tp_checkpoint(rank, world, card, state, mesh, cfg, ckpt_dir) -> dict:
    """Save ``state`` (the dp x tp shards), restore it onto a ('tp',)
    mesh of 4 and onto one device, and hold every gathered leaf
    bit-identical to the saved one."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import checkpoint as ck
    from nos_tpu_torch.parallel import make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import gather_shard, rule_leaves, tree_rules

    path = os.path.join(ckpt_dir, "state")
    dist.barrier()
    t0 = time.perf_counter()
    ck.save_checkpoint(path, state, 1, mesh=mesh)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(path) for f in files)
    tp4 = pm.mesh_from_devices((world,), ("tp",))
    _, shard_b = make_train_step(tp4, cfg, learning_rate=SP_TRAIN_LR)
    target = shard_b(llama.init_llama_params(cfg, seed=72, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    dist.barrier()
    t0 = time.perf_counter()
    onto, step_b = ck.restore_checkpoint(path, target, mesh=tp4)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    single, one_s = None, None
    if rank == 0:
        _, shard_1 = make_train_step(None, cfg, learning_rate=SP_TRAIN_LR)
        single = shard_1(llama.init_llama_params(cfg, seed=73, device="cuda"), donate=True)
        t0 = time.perf_counter()
        single, _ = ck.restore_checkpoint(path, single)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    dist.barrier()
    specs_a = rule_leaves(tree_rules(state[0], mesh))
    specs_b = rule_leaves(tree_rules(onto[0], tp4))
    trees_a = [state[0], state[1]]
    trees_b = [onto[0], onto[1]]
    mismatched_tp4, mismatched_one, n = 0, 0, 0
    for t, (ta, tb) in enumerate(zip(trees_a, trees_b)):
        ones = llama.tree_leaves(single[t]) if single is not None else None
        for i, (a, b, sa, sb) in enumerate(zip(llama.tree_leaves(ta), llama.tree_leaves(tb),
                                               specs_a, specs_b)):
            wa = gather_shard(a.detach(), sa, mesh)
            wb = gather_shard(b.detach(), sb, tp4)
            mismatched_tp4 += int(not torch.equal(wa, wb))
            if ones is not None:
                mismatched_one += int(not torch.equal(wa, ones[i].detach()))
            n += 1
            del wa, wb
    row = {"phase": "checkpoint", "config": "llama_3_8b", "rank": rank,
           "saved_mesh": {"dp": 2, "tp": 2}, "restored_mesh": {"tp": world},
           "leaves": n, "bytes_on_disk": nbytes, "save_s": save_s,
           "restore_tp4_s": restore_s, "restored_step": step_b,
           "leaves_differing_tp4": mismatched_tp4, "card": card}
    ok = mismatched_tp4 == 0 and step_b == 1
    if rank == 0:
        row.update(restore_one_device_s=one_s, leaves_differing_one_device=mismatched_one)
        ok = ok and mismatched_one == 0
    row["ok"] = ok
    if not ok:
        sp_fail(row, "checkpoint")
    return row


def tp_phases(card) -> dict:
    """The tensor-parallel phases on spawned ranks: tp_forward at tp 2
    (full depth) and tp_generate / tp_engine (bf16 and int8) on two ranks;
    tp_forward at tp 4 (TP4_FORWARD_LAYERS deep), tp_train (dp 2 x tp 2,
    FSDP, remat) and checkpoint (saved, restored onto tp 4 and onto one
    device) on four. The parent holds no card memory."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.time()
    two = sp_spawn(2, [
        ("tp_forward_case", dict(seq=TP_FORWARD_SEQ)),
        ("tp_engine_case", dict(new_tokens=TP_ENGINE_NEW)),
        ("tp_lora_train_case", {}),
        ("tp_spec_engine_case", {}),
    ], card)
    t_two = time.time() - t0
    ckpt_dir = tempfile.mkdtemp(prefix="nos-ckpt-")
    try:
        t0 = time.time()
        four = sp_spawn(4, [
            ("tp_forward_case", dict(seq=TP_FORWARD_SEQ, layers=TP4_FORWARD_LAYERS)),
            ("tp_train_case", dict(layers=TP_TRAIN_LAYERS, tokens_shape=TP_TRAIN_TOKENS,
                                   ckpt_dir=ckpt_dir)),
        ], card)
        t_four = time.time() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    forward = [rows[0] for rows in two] + [rows[0] for rows in four]
    serving = [row for i in range(3) for rows in two for row in [rows[1][i]]]
    train = [rows[1][0] for rows in four]
    checkpoint = [rows[1][1] for rows in four]
    lora = [rows[2] for rows in two]
    spec = [rows[3] for rows in two]
    for row in forward + serving + train + checkpoint + lora + spec:
        emit(row)
    emit({"phase": "tp_phases", "seconds_two_ranks": t_two, "seconds_four_ranks": t_four,
          "card": card})
    launches = {f"tp_forward.tp{row['tp']}": [] for row in forward}
    for row in forward:
        launches[f"tp_forward.tp{row['tp']}"].append(row["launches_fwd_dq_dkv"])
    launches["tp_generate.tp2"] = [row["launches_fwd_dq_dkv"] for row in serving
                                   if row["phase"] == "tp_generate"]
    launches["tp_train.dp2_tp2_fsdp_remat"] = [row["launches_fwd_dq_dkv"] for row in train]
    launches["tp_lora_train.tp2_remat_per_step"] = [row["launches_per_step_fwd_dq_dkv"][-1]
                                                    for row in lora]
    return {"launches": launches}


# Expert and pipeline parallelism, LoRA and SpecEngine under a mesh, on
# ranks sharing the card over gloo
EP_LAYER_TOKENS = 2048   # one Mixtral MoE layer: [1, 2048] over ep 4, [2, 1024] over dp 2 x ep 2
EP_FORWARD_SEQ = 2048    # Mixtral-8x7B int8 at full depth over ep 4
EP_GENERATE_NEW = 16     # the first 16 of the one-device generate()'s 32 tokens
EP_TRAIN_TOKENS = (4, 2048)  # Mixtral at 2 layers, dp 2 x ep 2
PP_FORWARD_TOKENS = (4, 2048)  # Llama-3-8B at full depth over pp 4, M 4
PP_TRAIN_LAYERS = 8
PP_TRAIN_TOKENS = (4, 2048)  # dp 2 x pp 2, M 2
EP_REL_LIMIT = 1e-2      # one MoE layer over ep against one device, rel. Frobenius
EP_LAYER_SKEW = 0.5      # scale of the hidden states' shared component (load skew)
TP_LORA_LAYERS = 4
TP_LORA_TOKENS = (4, 2048)
TP_SPEC_NEW = 16


def layered_params(cfg, seed, layers=None, top_fn=None):
    """A random model of ``cfg`` drawn one layer at a time: layer i is the
    layer of a one-layer model drawn from ``seed + i``, the embedding,
    final norm and head those of the draw of ``seed``. Only ``layers``
    (all by default) are drawn and kept, each draw through ``top_fn``
    first (optional), so a rank draws just its own layers and experts and
    every rank's share of one model is the same whatever the split."""
    from nos_tpu_torch.models import llama

    one = dataclasses.replace(cfg, n_layers=1)
    keep = list(range(cfg.n_layers)) if layers is None else list(layers)
    tree = None
    for i in sorted(set(keep) | {0}):
        draw = llama.init_llama_params(one, seed=seed + i, device="cuda")
        if top_fn is not None:
            draw = top_fn(draw)
        if tree is None:
            tree = dict(draw, layers=[])
        if i in keep:
            tree["layers"].append(draw["layers"][0])
        del draw
    return tree


def moe_slice(mesh):
    """A layer's ``moe`` node cut to this rank's experts (and d_ff /
    d_model shards) by the sharding rules."""
    from nos_tpu_torch.parallel.sharding import _zip_map, take_shard, tree_rules

    def cut(layer):
        rules = tree_rules({"moe": layer["moe"]}, mesh)["moe"]
        return dict(layer, moe=_zip_map(lambda x, s: take_shard(x, s, mesh),
                                        layer["moe"], rules))

    return cut


def mixtral_int8_rank_tree(cfg, mesh, seed=51):
    """The rank's share over ``mesh`` of ``mixtral_int8_tree(cfg, seed)``,
    drawn layer by layer: its E/ep experts of every layer (cut from the
    bf16 draw before quantizing: an int8 stack's scales are per expert
    and output column, so cutting first gives the same bytes), the rest
    whole."""
    from nos_tpu_torch.models.quantize import quantize_params

    cut = moe_slice(mesh)

    def rank_share(draw):
        return quantize_params(dict(draw, layers=[cut(draw["layers"][0])]))

    return layered_params(cfg, seed, top_fn=rank_share)


def ep_layer_case(rank, world, card) -> dict:
    """One full-width bf16 Mixtral MoE layer (seeded random router and
    experts, seeded hidden states of 2048 tokens sharing one component,
    so that at the default capacity factor capacity binds: held) over ep
    4 on [1, 2048] and over dp 2 x
    ep 2 on [2, 1024] (the same 2048 tokens), against the one-device
    moe_mlp on the same input: the kept-pair set exactly, the output
    within EP_REL_LIMIT (relative Frobenius); the bytes each collective
    received on this rank, and its host-staged time."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import moe as tm
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = mixtral_config()
    mc = cfg.moe_config()
    d, k, e = cfg.d_model, mc.top_k, mc.n_experts
    gen = torch.Generator(device="cuda").manual_seed(81)
    params = tm.init_moe_params(gen, mc)
    # a component shared by every token skews the router's load, so the
    # default capacity binds (about 18% of the pairs dropped)
    shared = EP_LAYER_SKEW * torch.randn((d,), generator=gen, device="cuda")
    x = (torch.randn((1, EP_LAYER_TOKENS, d), generator=gen, device="cuda")
         + shared).to(cfg.dtype)
    cap = tm.capacity_per_expert(EP_LAYER_TOKENS, mc)
    with torch.no_grad():
        want = tm.moe_mlp(params, x, mc)
        keep_one = tm._route(x.reshape(-1, d), params["router"], mc)[4]
    dropped = int((~keep_one).sum())
    rows = []
    for dims, names, shape in (((4,), ("ep",), (1, EP_LAYER_TOKENS)),
                               ((2, 2), ("dp", "ep"), (2, EP_LAYER_TOKENS // 2))):
        mesh = pm.mesh_from_devices(dims, names)
        ep, dp = pm.axis_size(mesh, "ep"), pm.axis_size(mesh, "dp")
        block = llama_data_sharding(mesh, x.reshape(*shape, d)).contiguous()
        shards = moe_slice(mesh)({"moe": params})["moe"]
        want_block = llama_data_sharding(mesh, want.reshape(*shape, d))
        keep_want = llama_data_sharding(mesh, keep_one.reshape(*shape, k)).reshape(-1)
        torch.cuda.synchronize()
        dist.barrier()
        with torch.no_grad(), comm.timed_collectives() as times:
            t0 = time.perf_counter()
            got = tm.moe_mlp(shards, block, mc, mesh)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            keep = tm._route(block.reshape(-1, d), shards["router"], mc, None, mesh,
                             block.shape[0])[4]
        row = {"phase": "ep_layer", "config": "mixtral_8x7b", "rank": rank,
               "mesh": dict(zip(names, dims)), "hidden": list(shape),
               "hidden_rank": list(block.shape[:2]), "capacity": cap,
               "capacity_factor": mc.capacity_factor,
               "kept_pairs_rank": int(keep.sum()), "pairs_rank": int(keep.numel()),
               "dropped_pairs_one_device": dropped,
               "kept_set_equal": bool(torch.equal(keep, keep_want)),
               "rel_frobenius_err": rel_frobenius(got, want_block),
               "rel_limit": EP_REL_LIMIT,
               "experts_rank": int(shards["w_gate"].shape[0]),
               # received on this rank: the other ep ranks' expert outputs
               # [E/ep, C, d] bf16, and the per-row routing counts [B/dp, E]
               # int64 of the other dp ranks
               "bytes_received": {
                   "ep_gather_out_e": (ep - 1) * (e // ep) * cap * d * 2,
                   "ep_race_counts": (dp - 1) * block.shape[0] * e * 8},
               "collective_calls": {kk: len(v) for kk, v in times.items()},
               "collective_ms_gloo_host_staged": {kk: sum(v) for kk, v in times.items()},
               "wall_ms_gloo_host_staged": wall, "card": card}
        row["ok"] = row["kept_set_equal"] and row["rel_frobenius_err"] <= EP_REL_LIMIT \
            and row["experts_rank"] == e // ep and dropped > 0
        if not row["ok"]:
            sp_fail(row, "ep_layer")
        rows.append(row)
    return rows


def ep_serve_case(rank, world, card, ref_path) -> list:
    """Mixtral-8x7B in int8 at full depth over ep 4: each rank draws the
    one-device tree's layers from the same per-layer seeds and keeps its 2
    experts of each, one rank after another. ep_forward: llama_forward on
    [1, EP_FORWARD_SEQ]
    (one forward launch a layer), the same logits on every rank, against
    the one-device logits (random routers, reported and held to the
    forward_check bars). ep_generate: generate() on [2, 512] +
    EP_GENERATE_NEW, the same tokens on every rank, against the
    one-device tokens (reported)."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.parallel import comm, mesh as pm

    cfg = mixtral_config()
    mesh = pm.mesh_from_devices((world,), ("ep",))
    torch.cuda.reset_peak_memory_stats()
    # one rank draws at a time: a draw holds a whole bf16 layer (2.8 GB)
    # beside the shares already built
    for r in range(world):
        if r == rank:
            t0 = time.perf_counter()
            tree = mixtral_int8_rank_tree(cfg, mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
        dist.barrier()
    ref = torch.load(os.path.join(ref_path, "serve.pt"))
    gen = torch.Generator(device="cuda").manual_seed(53)
    tokens = torch.randint(0, cfg.vocab_size, (1, EP_FORWARD_SEQ), generator=gen, device="cuda")
    dist.barrier()
    with torch.no_grad(), comm.timed_collectives() as times:
        zero_counts()  # the ep forward path
        t0 = time.perf_counter()
        got = llama.llama_forward(tree, tokens, cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "ep_forward", "config": "mixtral_8x7b", "weights": "int8",
           "rank": rank, "ep": world, "tokens": [1, EP_FORWARD_SEQ],
           "experts_rank": int(tree["layers"][0]["moe"]["w_gate"].q.shape[0]),
           "weight_bytes_rank": weight_bytes(tree), "build_s": build_s,
           "transport": comm.transport(mesh.get_group("ep"), "cuda"),
           "launches_fwd_dq_dkv": list(launches), "expected_launches": [cfg.n_layers, 0, 0],
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "collective_calls": {k: len(v) for k, v in times.items()},
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = list(launches) == row["expected_launches"] and row["same_logits_every_rank"] \
        and row["experts_rank"] == cfg.n_experts // world
    if rank == 0:
        want = torch.load(os.path.join(ref_path, "logits.pt")).cuda()
        stats = logits_agreement(got, want)
        row.update(stats, bit_identical_to_one_device=bool(torch.equal(got, want)),
                   rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
        del want
    row["ok"] = ok
    if not ok:
        sp_fail(row, "ep_forward")
    del got
    torch.cuda.empty_cache()
    prompt = ref["prompt"].cuda()
    dist.barrier()
    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        out = gen_mod.generate(tree, prompt, cfg, EP_GENERATE_NEW, mesh=mesh).tolist()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        g_launches = counts()
    grow = {"phase": "ep_generate", "config": "mixtral_8x7b", "weights": "int8",
            "rank": rank, "ep": world, "prompt": [2, 512], "new_tokens": EP_GENERATE_NEW,
            "launches_fwd_dq_dkv": list(g_launches),
            "expected_launches": [cfg.n_layers, 0, 0],
            "same_tokens_every_rank": same_on_every_rank(out, world),
            "seconds_gloo_host_staged": gen_s,
            "tokens_per_s": 2 * EP_GENERATE_NEW / gen_s, "card": card}
    if rank == 0:
        one = ref["generated"][:, :EP_GENERATE_NEW].tolist()
        grow.update(token_agreement_with_one_device=agreement(out, one),
                    first_token_equal=[a[0] == b[0] for a, b in zip(out, one)])
    grow["ok"] = (grow["same_tokens_every_rank"] and list(g_launches) ==
                  grow["expected_launches"] and all(len(r) == EP_GENERATE_NEW for r in out))
    if not grow["ok"]:
        sp_fail(grow, "ep_generate")
    return [row, grow]


def ep_train_case(rank, world, card) -> dict:
    """Mixtral-8x7B at full width, 2 layers (bf16, flash, random routers):
    one momentum-SGD step from zero velocity over dp 2 x ep 2 with FSDP and
    remat on [4, 2048], against the one-device make_train_step(None) step
    (rank 0 runs it first, alone) under the tp_train bars; the launches
    of each kernel (forward 2·L with the replay, dQ L, dK/dV L), the
    rank's param bytes (a quarter of the experts, half of the FSDP-sharded
    rest, the replicated norms and routers), its peak, and the step's
    host time split by collective kind."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = mixtral_config(n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(83)
    tokens = torch.randint(0, cfg.vocab_size, EP_TRAIN_TOKENS, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 83, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "ep"))
    step, shard = make_train_step(mesh, dataclasses.replace(cfg, remat=True),
                                  learning_rate=SP_TRAIN_LR)
    state = shard(llama.init_llama_params(cfg, seed=83, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    leaves = llama.tree_leaves(state[0])
    param_bytes = sum(p.numel() * p.element_size() for p in leaves)
    block = llama_data_sharding(mesh, tokens).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the ep x FSDP training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        state, loss = step(state, block)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
    agree = same_on_every_rank(compared.pop("velocity_checksum"), world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    layers = cfg.n_layers
    row = {"phase": "ep_train", "config": "mixtral_8x7b", "layers": layers,
           "mesh": {"dp": 2, "ep": 2}, "fsdp": True, "remat": True, "rank": rank,
           "tokens": list(EP_TRAIN_TOKENS), "tokens_rank": list(block.shape),
           "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
           "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * layers, layers, layers], "replicas_agree": agree,
           "experts_rank": int(state[0]["layers"][0]["moe"]["w_gate"].shape[0]),
           "param_bytes_rank": param_bytes, "peak_gib": peak,
           "step_ms_with_split_gloo_host_staged": wall,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall - sum(collective_ms.values()), **compared, "card": card}
    ok = agree and list(launches) == row["expected_launches"] and row["experts_rank"] == 4
    if rank == 0:
        whole = sum(2 * math.prod(p.shape) for p in ref["p0"])
        row.update(param_bytes_whole=whole, grad_rel_limit=SP_GRAD_REL_LIMIT,
                   loss_limit=TP_LOSS_LIMIT)
        ok = ok and held_to_one_device(row, TP_LOSS_LIMIT)
        del ref
    row["ok"] = ok
    if not ok:
        sp_fail(row, "ep_train")
    return row


def stage_shards(stage_tree, mesh, cfg):
    """This rank's shards of a stacked tree that holds only its stage's
    layers: the pipeline rules with pp taken as already applied."""
    from nos_tpu_torch.parallel.pipeline import pipeline_param_sharding
    from nos_tpu_torch.parallel.sharding import _zip_map, take_shard

    def no_pp(rule):
        if isinstance(rule, tuple):
            return tuple(None if a == "pp" else a for a in rule)
        return {k: no_pp(v) for k, v in rule.items()}

    rules = no_pp(pipeline_param_sharding(mesh, cfg))
    return _zip_map(lambda x, s: take_shard(x, s, mesh), stage_tree, rules)


def pp_forward_case(rank, world, card) -> dict:
    """Llama-3-8B at full width and depth (bf16, flash, random weights
    drawn layer by layer) through pipeline_llama_forward over pp 4 (8
    layers a stage), [4, 2048] in 4 microbatches, against the one-device
    flash forward (rank 0 runs it first, alone) under forward_check's
    limits; M · L/pp forward launches a rank (the bubble ticks skip their
    compute), the same logits on every rank, the hops' and the
    broadcast's host-staged time."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel import pipeline as pl

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(91)
    tokens = torch.randint(0, cfg.vocab_size, PP_FORWARD_TOKENS, generator=gen, device="cuda")
    want = None
    if rank == 0:
        whole = layered_params(cfg, 91)
        with torch.no_grad():
            want = llama.llama_forward(whole, tokens, cfg)
        del whole
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("pp",))
    per = cfg.n_layers // world
    stage = pl.stack_layer_params(layered_params(cfg, 91, range(rank * per, (rank + 1) * per)))
    m = world
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    with torch.no_grad(), comm.timed_collectives() as times:
        zero_counts()  # the pipeline forward path
        t0 = time.perf_counter()
        got = pl.pipeline_llama_forward(stage, tokens, cfg, mesh, m)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "pp_forward", "config": "llama_3_8b", "rank": rank, "pp": world,
           "microbatches": m, "tokens": list(PP_FORWARD_TOKENS), "layers_rank": per,
           "launches_fwd_dq_dkv": list(launches), "expected_launches": [m * per, 0, 0],
           "ticks": m + world - 1, "bubble_share": (world - 1) / (m + world - 1),
           "hop_bytes": 2 * (PP_FORWARD_TOKENS[0] // m) * PP_FORWARD_TOKENS[1] * cfg.d_model,
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "collective_calls": {k: len(v) for k, v in times.items()},
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "wall_ms_gloo_host_staged": wall,
           "param_bytes_rank": sum(p.numel() * p.element_size()
                                   for p in llama.tree_leaves(stage)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = list(launches) == row["expected_launches"] and row["same_logits_every_rank"]
    if rank == 0:
        stats = logits_agreement(got, want)
        row.update(stats, rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
    row["ok"] = ok
    if not ok:
        sp_fail(row, "pp_forward")
    return row


def pp_train_case(rank, world, card) -> dict:
    """Llama-3-8B at full width, PP_TRAIN_LAYERS deep (bf16, flash, drawn
    layer by layer), pipeline_loss_and_grads over dp 2 x pp 2 with FSDP
    and remat, [4, 2048] in 2 microbatches, against the one-device
    llama_loss and its gradients (rank 0, first, alone) under the
    tp_train bars (each leaf kind's gradient within 3% of its largest);
    the launches of each kernel a rank (forward 2 · M · L/pp with the
    replay, dQ and dK/dV M · L/pp), the bubble share, and the step's
    host time split by collective kind (the hops under "pp")."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel import pipeline as pl

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash",
                              n_layers=PP_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(93)
    tokens = torch.randint(0, cfg.vocab_size, PP_TRAIN_TOKENS, generator=gen, device="cuda")
    ref = None
    if rank == 0:
        whole = layered_params(cfg, 93)
        leaves = [p.requires_grad_(True) for p in llama.tree_leaves(whole)]
        loss_one = llama.llama_loss(whole, tokens, cfg)
        grads = torch.autograd.grad(loss_one, leaves)
        it = iter(grads)
        g_tree = llama.tree_map(lambda _: next(it), whole)
        ref = {"loss": float(loss_one),
               "g": [g.cpu() for g in llama.tree_leaves(pl.stack_layer_params(g_tree))]}
        del whole, leaves, grads, g_tree, loss_one
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "pp"))
    pp, s = pm.axis_size(mesh, "pp"), pm.axis_index(mesh, "pp")
    per = cfg.n_layers // pp
    m = 2
    remat = dataclasses.replace(cfg, remat=True)
    stage = pl.stack_layer_params(layered_params(cfg, 93, range(s * per, (s + 1) * per)))
    shards = stage_shards(stage, mesh, remat)
    del stage
    torch.cuda.empty_cache()
    rows = pl.pipeline_data_sharding(mesh, tokens, m).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the pipeline training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        loss, grads = pl.pipeline_loss_and_grads(shards, rows, remat, mesh, m)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    it = iter(grads)
    whole = pl.gather_pipeline_params(llama.tree_map(lambda _: next(it), shards), mesh, remat)
    g_whole = llama.tree_leaves(whole)
    checksum = sum(float(g.double().sum()) for g in g_whole)
    agree = same_on_every_rank(checksum, world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    row = {"phase": "pp_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "mesh": {"dp": 2, "pp": 2}, "fsdp": True, "remat": True, "rank": rank,
           "microbatches": m, "tokens": list(PP_TRAIN_TOKENS), "tokens_rank": list(rows.shape),
           "layers_rank": per, "loss": float(loss),
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * m * per, m * per, m * per],
           "ticks": m + pp - 1, "bubble_share": (pp - 1) / (m + pp - 1),
           "replicas_agree": agree,
           "param_bytes_rank": sum(p.numel() * p.element_size()
                                   for p in llama.tree_leaves(shards)),
           "peak_gib": peak, "step_ms_with_split_gloo_host_staged": wall,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall - sum(collective_ms.values()), "card": card}
    ok = agree and list(launches) == row["expected_launches"] and \
        bool(all(torch.isfinite(g).all() for g in g_whole))
    if rank == 0:
        diff, top = {}, {}
        for (kind, _), g, w in zip(named_stacked(whole), g_whole, ref["g"]):
            w = w.cuda().float()
            diff[kind] = max(diff.get(kind, 0.0), float((g.float() - w).abs().max()))
            top[kind] = max(top.get(kind, 0.0), float(w.abs().max()))
        row.update(one_device_loss=ref["loss"], loss_abs_diff=abs(float(loss) - ref["loss"]),
                   grad_rel_err={k: diff[k] / top[k] for k in diff},
                   loss_limit=TP_LOSS_LIMIT, grad_rel_limit=SP_GRAD_REL_LIMIT)
        ok = ok and row["loss_abs_diff"] <= TP_LOSS_LIMIT and \
            max(row["grad_rel_err"].values()) <= SP_GRAD_REL_LIMIT
    row["ok"] = ok
    if not ok:
        sp_fail(row, "pp_train")
    return row


def named_stacked(tree):
    """(kind, tensor) of a stacked tree in tree_leaves order."""
    for key, value in tree.items():
        if key == "layers":
            for name, leaf in value.items():
                if isinstance(leaf, dict):
                    yield from ((f"{name}.{k}", v) for k, v in leaf.items())
                else:
                    yield name, leaf
        else:
            yield key, value


def tp_lora_train_case(rank, world, card) -> dict:
    """make_lora_train_step over tp 2: Llama-3-8B at full width,
    TP_LORA_LAYERS deep (bf16, flash, remat), rank 8 on wq / wv, three
    Adam steps on [4, 2048], against the one-device LoRA step (rank 0,
    first, alone): the losses within TP_LOSS_LIMIT, and each adapter's
    first moment after the three steps (Adam's exp_avg, a weighted sum of
    the steps' whole gradients: a tp x or 1/tp gradient would miss by
    50-100%) within SP_GRAD_REL_LIMIT (relative Frobenius; the largest
    elementwise error over the leaf's largest reported). B starts from a
    seeded 0.01-scale draw, not zeros, so A's gradient is live and well
    conditioned from the first step. The adapters' change over the steps
    is reported beside it, not held: Adam's first steps move each element
    by about lr whatever its gradient's size, so bf16 rounding flips the
    step of elements whose gradient is near zero. The launches a step,
    the step's host time split by collective kind."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash", remat=True,
                              n_layers=TP_LORA_LAYERS)
    lc = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    gen = torch.Generator(device="cuda").manual_seed(101)
    tokens = torch.randint(0, cfg.vocab_size, TP_LORA_TOKENS, generator=gen, device="cuda")

    def adapters():
        tree = tlora.init_lora_params(cfg, lc, seed=101)
        b_gen = torch.Generator(device="cuda").manual_seed(102)
        for layer in tree["layers"]:
            for ab in layer.values():
                ab["b"] = 0.01 * torch.randn(ab["b"].shape, generator=b_gen, device="cuda")
        return tree

    def three_steps(mesh, base):
        step, shard = tlora.make_lora_train_step(mesh, cfg, lc, learning_rate=1e-3)
        state = shard(adapters())
        start = [t.detach().clone() for t in llama.tree_leaves(state[0])]
        losses, ms, per_step = [], [], []
        for _ in range(3):
            at = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, base, tokens)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            per_step.append([a - b for a, b in zip(counts(), at)])
        leaves = llama.tree_leaves(state[0])
        moved = [(t.detach() - s).float() for t, s in zip(leaves, start)]
        moments = [state[1].state[p]["exp_avg"].float() for p in leaves]
        return losses, ms, per_step, moved, moments

    one = None
    if rank == 0:
        base = llama.init_llama_params(cfg, seed=101, device="cuda")
        one = three_steps(None, base)
        del base
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("tp",))
    base = shard_params(llama.init_llama_params(cfg, seed=101, device="cuda"), mesh, cfg)
    torch.cuda.empty_cache()
    dist.barrier()
    zero_counts()  # the tp LoRA training path
    with comm.timed_collectives() as times:
        losses, ms, per_step, moved, moments = three_steps(mesh, base)
    checksum = sum(float(t.double().sum()) for t in moved + moments)
    row = {"phase": "tp_lora_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "rank": rank, "tp": world, "lora_rank": 8, "targets": list(lc.targets),
           "tokens": list(TP_LORA_TOKENS), "optimizer": "torch.optim.Adam(lr=1e-3)",
           "remat": True, "losses": losses, "step_ms_gloo_host_staged": ms,
           "launches_per_step_fwd_dq_dkv": per_step,
           "expected_launches": [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers],
           "adapters_agree_every_rank": same_on_every_rank(checksum, world),
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "collective_calls": {k: len(v) for k, v in times.items()}, "card": card}
    ok = row["adapters_agree_every_rank"] and \
        all(s == row["expected_launches"] for s in per_step)
    if rank == 0:
        w_losses, w_ms, _, w_moved, w_moments = one
        frob = [float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                for g, w in zip(moved, w_moved)]
        first = [float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                 for g, w in zip(moments, w_moments)]
        first_max = [float((g - w).abs().max() / w.abs().max())
                     for g, w in zip(moments, w_moments)]
        row.update(one_device_losses=w_losses, one_device_step_ms=w_ms,
                   loss_abs_diff=max(abs(a - b) for a, b in zip(losses, w_losses)),
                   first_moment_rel_frobenius_max=max(first),
                   first_moment_rel_elementwise_max=max(first_max),
                   adapter_change_rel_frobenius_max=max(frob),
                   loss_limit=TP_LOSS_LIMIT, first_moment_limit=SP_GRAD_REL_LIMIT)
        ok = ok and row["loss_abs_diff"] <= TP_LOSS_LIMIT and max(first) <= SP_GRAD_REL_LIMIT
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_lora_train")
    return row


def tp_spec_engine_case(rank, world, card) -> dict:
    """SpecEngine over tp 2: the Llama-3-8B target at full depth (bf16,
    flash) on the rank's shard_for_serving shards and head-sharded cache,
    a 2-layer draft (its first layers, sharing the embedding and head)
    whole on every rank, k = 4, four requests of TP_SPEC_NEW tokens
    admitted in 16-token pieces: the same tokens on every rank; against
    the one-device SpecEngine (rank 0, first) the share of equal tokens
    is reported."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.serve import GenRequest, SpecEngine, shard_for_serving

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=103, device="cuda")
    draft = dict(params, layers=params["layers"][:2])
    dcfg = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(103)
    pool = torch.randint(1, cfg.vocab_size, (600,), generator=gen, device="cuda").tolist()
    prompts = [pool[:20], pool[20:120], pool[120:320], pool[320:530]]

    def serve(tree, mesh):
        eng = SpecEngine(tree, cfg, draft, dcfg, k=4, max_slots=4, max_len=512,
                         prefill_chunk=16, mesh=mesh)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=TP_SPEC_NEW))
                   for p in prompts]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.perf_counter() - t0, eng.stats()

    one = serve(params, None) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("tp",))
    shards = shard_for_serving(params, mesh, cfg)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    zero_counts()
    toks, seconds, stats = serve(shards, mesh)
    row = {"phase": "tp_spec_engine", "config": "llama_3_8b", "rank": rank, "tp": world,
           # admission is chunked (decode_chunk's einsum attention): no kernel
           "launches_fwd_dq_dkv": list(counts()),
           "draft_layers": 2, "k": 4, "prefill_chunk": 16, "requests": len(prompts),
           "prompt_tokens": [len(p) for p in prompts], "new_tokens": TP_SPEC_NEW,
           "rounds": stats["rounds"], "mean_accepted": stats["mean_accepted"],
           "same_tokens_every_rank": same_on_every_rank(toks, world),
           "seconds_gloo_host_staged": seconds,
           "tokens_per_s": TP_SPEC_NEW * len(prompts) / seconds, "card": card}
    ok = row["same_tokens_every_rank"] and all(
        len(t) == TP_SPEC_NEW and all(0 <= x < cfg.vocab_size for x in t) for t in toks)
    if rank == 0:
        row.update(one_device_seconds=one[1], one_device_mean_accepted=one[2]["mean_accepted"],
                   token_agreement_with_one_device=agreement(toks, one[0]),
                   first_token_equal=[a[0] == b[0] for a, b in zip(toks, one[0])])
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_spec_engine")
    return row


def ep_pp_phases(card, ref_path) -> dict:
    """The expert- and pipeline-parallel phases on four spawned ranks, one
    spawn: ep_layer, ep_forward and ep_generate (Mixtral int8 over ep 4,
    against the one-device results the mixtral_int8 phase left in
    ``ref_path``), ep_train (dp 2 x ep 2), pp_forward and pp_train. Each
    case frees its card memory before the next. The parent holds no card
    memory."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = sp_spawn(4, [("ep_layer_case", {}), ("ep_serve_case", dict(ref_path=ref_path)),
                         ("ep_train_case", {}), ("pp_forward_case", {}),
                         ("pp_train_case", {})], card)
    seconds = time.time() - t0
    layer = [r for rows in ranks for r in rows[0]]
    forward = [rows[1][0] for rows in ranks]
    generate = [rows[1][1] for rows in ranks]
    train = [rows[2] for rows in ranks]
    pp_forward = [rows[3] for rows in ranks]
    pp_train = [rows[4] for rows in ranks]
    for row in layer + forward + generate + train + pp_forward + pp_train:
        emit(row)
    emit({"phase": "ep_pp_phases", "seconds_four_ranks": seconds, "card": card})
    return {"launches": {
        "ep_forward.ep4": [r["launches_fwd_dq_dkv"] for r in forward],
        "ep_generate.ep4": [r["launches_fwd_dq_dkv"] for r in generate],
        "ep_train.dp2_ep2_fsdp_remat": [r["launches_fwd_dq_dkv"] for r in train],
        "pp_forward.pp4": [r["launches_fwd_dq_dkv"] for r in pp_forward],
        "pp_train.dp2_pp2_fsdp_remat": [r["launches_fwd_dq_dkv"] for r in pp_train]}}


def sp_launches(sp, index: int, hd256: bool) -> dict:
    """Per-rank launches of kernel ``index`` (0 forward, 1 dQ, 2 dK/dV) on
    each sp path, at head_dim 256 or at 128."""
    return {path: [r[index] for r in per_rank] for path, per_rank in sp["launches"].items()
            if ("gemma" in path) == hd256}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "nos_tpu_torch", "__init__.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(nos_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.time()
    card = card_line()

    # ------------------------------------------------------------- build
    from nos_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build(_build.KERNELS)
    fwd_ptxas = {f"hd{hd}": figures
                 for entry, figures in _build.ptxas_report("flash_fwd").items()
                 for hd in (64, 128, 256) if f"ILi{hd}E" in entry}
    bwd_figures = bwd_ptxas()
    emit({"phase": "build", "kernels": sorted(libs), "seconds": time.time() - t0,
          "seconds_per_kernel": dict(_build.BUILD_SECONDS),
          "flash_fwd_ptxas": fwd_ptxas, "flash_bwd_ptxas": bwd_figures,
          "card": card})

    # ----------------------------------------------------------- kernels
    import nos_tpu_torch.ops.flash_attention as fa

    main_case = check_attention(card, "generate_prefill_b2_s512", 2, 512, 512)
    check_attention(card, "causal_b2_s2048", 2, 2048, 2048)
    check_attention(card, "causal_ragged_s1000", 1, 1000, 1000)
    check_attention(card, "window512_s2048", 1, 2048, 2048, window=512)
    check_attention(card, "noncausal_s512", 1, 512, 512, causal=False)
    check_attention(card, "block_kv_offset", 1, 512, 512, q_off=1024, kv_off=512)
    check_attention(card, "block_fully_future", 1, 256, 256, q_off=0,
                    kv_off=4096, timed=False)
    # the tile edges of the 128 x 128 kernel, untimed
    for n in (127, 129, 255):
        check_attention(card, f"ragged_s{n}", 1, n, n, timed=False)
    check_attention(card, "window200_offsets_off_tile", 1, 300, 400, q_off=333,
                    kv_off=45, window=200, timed=False)
    check_attention(card, "skv_1", 2, 50, 1, timed=False)
    check_attention(card, "hd64_s1024", 1, 1024, 1024, hq=8, hkv=2, hd=64,
                    timed=False)
    check_attention(card, "q_transposed_view", 2, 200, 200, q_transposed=True,
                    timed=False)
    check_attention(card, "no_gqa_hq_eq_hkv", 1, 256, 256, hq=8, hkv=8, timed=False)
    train_case = check_attention(card, "train_shape_b4_s2048", TRAIN_BATCH,
                                 TRAIN_SEQ, TRAIN_SEQ)

    # the sixteen backward cases of tests/test_torch_cuda.py, then the
    # training shape, timed
    check_backward(card, "causal_b2_s128_hq4", 2, 128, 128, hq=4, hkv=2)
    check_backward(card, "causal_ragged_s100", 1, 100, 100, hq=8, hkv=2)
    check_backward(card, "window37_mqa_hd64_s200", 1, 200, 200, hq=4, hkv=1,
                   hd=64, window=37)
    check_backward(card, "noncausal_ragged_s77", 2, 77, 77, hq=4, hkv=4,
                   causal=False)
    check_backward(card, "block_all_past", 1, 64, 96, hq=4, hkv=2, q_off=96)
    check_backward(card, "block_window_offsets", 1, 64, 96, hq=4, hkv=2,
                   q_off=40, kv_off=20, window=50)
    check_backward(card, "block_fully_future", 1, 64, 64, hq=4, hkv=2,
                   kv_off=1000)
    # the edges of the 64-row query tiles and 128-key blocks
    for n in (63, 65, 127, 129, 255):
        check_backward(card, f"ragged_s{n}", 2 if n == 255 else 1, n, n, hq=4, hkv=2)
    check_backward(card, "window200_offsets_off_tile", 1, 300, 400, hq=4, hkv=2,
                   q_off=333, kv_off=45, window=200)
    check_backward(card, "hd64_s1024", 1, 1024, 1024, hq=8, hkv=2, hd=64)
    check_backward(card, "no_gqa_hq_eq_hkv", 1, 256, 256, hq=4, hkv=4)
    check_backward(card, "skv_1", 2, 50, 1, hq=4, hkv=2)
    bwd_case = check_backward(card, "train_shape_b4_s2048", TRAIN_BATCH,
                              TRAIN_SEQ, TRAIN_SEQ, timed=True)
    hd256 = gemma_kernel_phases(card)

    # ------------------------------------------------------------- model
    from nos_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    t0 = time.time()
    params = llama.init_llama_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"]]
    ) + sum(t.numel() for layer in params["layers"] for t in layer.values())
    emit({"phase": "init", "config": "llama_3_8b", "params": n_params,
          "seconds": time.time() - t0,
          "gib": torch.cuda.memory_allocated() / 2**30, "card": card})

    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=tok_gen,
                           device="cuda")
    forward_check(card, "llama_forward", params, cfg, tokens)

    # the main path: generate() with the launch counts zeroed just before
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=tok_gen,
                           device="cuda")
    main_launches, out = generate_check(card, "generate", params, cfg, prompt)
    decode_check(card, "decode_step", "decode_profile", params, cfg, prompt,
                 out[:, 0], n_params)
    tiny_check(card, "tiny_card_vs_cpu", llama.tiny_config(
        d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, attention="flash"), tok_gen)

    # ------------------------------------------------------------ engine
    from nos_tpu_torch.serve import Engine, GenRequest
    from nos_tpu_torch.util import metrics

    rng_tokens = torch.randint(1, cfg.vocab_size, (2000,), generator=tok_gen,
                               device="cuda").tolist()
    shared = rng_tokens[:300]
    prompts = [
        rng_tokens[300:320],                      # 20: padded prefill
        shared + rng_tokens[320:370],             # 350: chunked, stores prefix
        shared + rng_tokens[370:460],             # 390: chunked, prefix hit
        rng_tokens[460:1160],                     # 700: chunked, 3 pieces
        rng_tokens[1160:1260],                    # 100: padded
        rng_tokens[1260:1460],                    # 200: padded (bucket 256)
    ]
    hits0 = metrics.SERVE_PREFIX_HITS.value
    ticks0 = metrics.SERVE_TICKS.value
    eng = Engine(params, cfg, max_slots=4, max_len=1024, prefill_chunk=256,
                 prefix_cache_entries=2)
    with torch.no_grad():
        fa.LAUNCHES = 0
        t0 = time.time()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    hits = metrics.SERVE_PREFIX_HITS.value - hits0
    lens_ok = all(len(results[i]) == 32 for i in ids)
    eng_ok = lens_ok and hits >= 1 and all(
        0 <= t < cfg.vocab_size for i in ids for t in results[i]
    )
    emit({"phase": "engine", "requests": len(ids),
          "prompt_tokens": [len(p) for p in prompts], "new_tokens": 32,
          "prefix_hits": hits, "seconds": wall,
          "tokens_per_s": 32 * len(ids) / wall,
          "decode_ticks": metrics.SERVE_TICKS.value - ticks0,
          "flash_launches": fa.LAUNCHES, "ok": eng_ok, "card": card})
    if not eng_ok:
        raise SystemExit(f"engine failed: lengths ok {lens_ok}, prefix hits {hits}")
    del eng

    # ------------------------------------------------ serving extensions
    trees = quantize_phase(card, params, cfg)
    generate_quant_phase(card, trees, cfg, prompt)
    decode_quant_phase(card, trees, cfg, prompt, out[:, 0])
    engine_quant_lora_phase(card, trees, cfg, prompts)
    spec_prompts = [rng_tokens[1460:1480], rng_tokens[1480:1580],
                    rng_tokens[1580:1780], rng_tokens[1780:1990]]
    spec_engine_phase(card, params, cfg, spec_prompts)

    # --------------------------------------------------------------- MoE
    # the Llama trees and caches go first: the int8 Mixtral holds ~47 GB
    del params, prompt, out, trees
    torch.cuda.empty_cache()
    t0 = time.time()
    moe_check_phase(card)
    moe_grads = moe_train_grads_phase(card)
    torch.cuda.empty_cache()
    import tempfile

    ep_ref = tempfile.mkdtemp(prefix="nos-ep-ref-")
    mixtral = mixtral_int8_phase(card, ep_ref)
    torch.cuda.empty_cache()  # the Mixtral tree goes before training (~51 GB)
    emit({"phase": "moe_phases", "seconds": time.time() - t0, "card": card})

    # ---------------------------------------------------------- training
    train_grads_phase(card)
    torch.cuda.empty_cache()
    train = train_phase(card)
    torch.cuda.empty_cache()
    train_adamw_phase(card)
    torch.cuda.empty_cache()
    lora = lora_train_phase(card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- Gemma
    # Gemma-2B (head_dim 256, one kv head) through the hd-256 kernels
    t0 = time.time()
    gemma = gemma_model_phase(card)
    torch.cuda.empty_cache()
    gemma_grads = train_grads_phase(card, llama.gemma_2b_config(),
                                    phase="gemma_train_grads", seed=23)
    torch.cuda.empty_cache()
    gemma_train = train_phase(card, llama.gemma_2b_config(), config="gemma_2b",
                              phase="gemma_train", seed=25)
    emit({"phase": "gemma_phases", "seconds": time.time() - t0, "card": card})
    torch.cuda.empty_cache()

    # -------------------------------------------------------- sp paths
    sp = sp_phases(card)

    # ------------------------------------------------------ tp and FSDP
    tp = tp_phases(card)

    # ------------------------------------------- expert and pipeline
    import shutil

    try:
        ep_pp = ep_pp_phases(card, ep_ref)
    finally:
        shutil.rmtree(ep_ref, ignore_errors=True)

    # ----------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/flash_attention.py:175",
        "launches": main_launches,
        "launches_mixtral_generate": mixtral["launches_generate"],
        "launches_moe_train_grads": moe_grads["launches_fwd_dq_dkv"][0],
        "max_abs_err": main_case["o_max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "q [2,512,32,128], k/v [2,512,8,128] bf16 causal",
        "launches_train": train["launches_total_fwd_dq_dkv"][0],
        "launches_lora_step": lora["launches_per_step_fwd_dq_dkv"][-1][0],
        "launches_sp_per_rank": sp_launches(sp, 0, False),
        "launches_tp_per_rank": sp_launches(tp, 0, False),
        "launches_ep_pp_per_rank": sp_launches(ep_pp, 0, False),
        "device_ms": main_case["kernel_device_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "ms_train": train_case["kernel_ms"],
        "tflops_train": train_case["kernel_tflops"],
        "bound_ms_train": train_case["bound_ms"],
        "library_ms_train": train_case["library_ms"],
        "shape_train": "q [4,2048,32,128], k/v [4,2048,8,128] bf16 causal",
        "ptxas": fwd_ptxas,
        "build_seconds": _build.BUILD_SECONDS.get("flash_fwd"),
        "check": "pass",
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": train["launches_total_fwd_dq_dkv"][index],
        "launches_lora_step": lora["launches_per_step_fwd_dq_dkv"][-1][index],
        "launches_moe_train_grads": moe_grads["launches_fwd_dq_dkv"][index],
        "launches_sp_per_rank": sp_launches(sp, index, False),
        "launches_tp_per_rank": sp_launches(tp, index, False),
        "launches_ep_pp_per_rank": sp_launches(ep_pp, index, False),
        "max_abs_err": max(bwd_case[f"{g}_max_abs_err"] for g in grads),
        "ms": bwd_case[f"{key}_ms"],
        "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case[f"{key}_bound_ms"],
        "bound_by": bwd_case[f"{key}_bound_by"],
        "library_ms": bwd_case["library_ms"],
        "shape": "q/dO [4,2048,32,128], k/v [4,2048,8,128] bf16 causal",
        "plain_and_library_cover": "dq, dk and dv together",
        "tflops_train": bwd_case[f"{key}_tflops"],
        "ptxas": {k: v for k, v in bwd_figures.items() if k.startswith(f"{key}_")},
        "build_seconds": _build.BUILD_SECONDS.get("flash_bwd"),
        "check": "pass",
    } for name, replaces, index, key, grads in (
        ("flash_dq", "nos_tpu/ops/flash_attention.py:326", 1, "dq", ("dq",)),
        ("flash_dkv", "nos_tpu/ops/flash_attention.py:368", 2, "dkv", ("dk", "dv")),
    )] + [{
        "name": "flash_fwd_hd256",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/flash_attention.py:175",
        "launches": gemma["generate_launches"],
        "launches_gemma_train": gemma_train["launches_total_fwd_dq_dkv"][0],
        "launches_gemma_train_grads": gemma_grads["launches_fwd_dq_dkv"][0],
        "launches_sp_per_rank": sp_launches(sp, 0, True),
        "max_abs_err": hd256["fwd_prefill"]["o_max_abs_err"],
        "ms": hd256["fwd_prefill"]["kernel_ms"],
        "plain_ms": hd256["fwd_prefill"]["plain_ms"],
        "bound_ms": hd256["fwd_prefill"]["bound_ms"],
        "bound_by": hd256["fwd_prefill"]["bound_by"],
        "library_ms": hd256["fwd_prefill"]["library_ms"],
        "shape": "q [2,512,8,256], k/v [2,512,1,256] bf16 causal",
        "device_ms": hd256["fwd_prefill"]["kernel_device_ms"],
        "library_device_ms": hd256["fwd_prefill"]["library_device_ms"],
        "ms_train": hd256["fwd_train"]["kernel_ms"],
        "tflops_train": hd256["fwd_train"]["kernel_tflops"],
        "bound_ms_train": hd256["fwd_train"]["bound_ms"],
        "plain_ms_train": hd256["fwd_train"]["plain_ms"],
        "library_ms_train": hd256["fwd_train"]["library_ms"],
        "device_ms_train": hd256["fwd_train"]["kernel_device_ms"],
        "shape_train": "q [4,2048,8,256], k/v [4,2048,1,256] bf16 causal",
        "ptxas": fwd_ptxas.get("hd256"),
        "check": "pass",
    }] + [{
        "name": f"{name}_hd256",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": gemma_train["launches_total_fwd_dq_dkv"][index],
        "launches_gemma_train_grads": gemma_grads["launches_fwd_dq_dkv"][index],
        "launches_sp_per_rank": sp_launches(sp, index, True),
        "max_abs_err": max(hd256["bwd_train"][f"{g}_max_abs_err"] for g in grads),
        "ms": hd256["bwd_train"][f"{key}_ms"],
        "device_ms": hd256["bwd_train"][f"{key}_device_ms"],
        "plain_ms": hd256["bwd_train"]["plain_ms"],
        "bound_ms": hd256["bwd_train"][f"{key}_bound_ms"],
        "bound_by": hd256["bwd_train"][f"{key}_bound_by"],
        "library_ms": hd256["bwd_train"]["library_ms"],
        "shape": "q/dO [4,2048,8,256], k/v [4,2048,1,256] bf16 causal",
        "plain_and_library_cover": "dq, dk and dv together",
        "tflops_train": hd256["bwd_train"][f"{key}_tflops"],
        "ptxas": {k: v for k, v in bwd_figures.items()
                  if k.startswith(f"{key}_hd256")},
        "check": "pass",
    } for name, replaces, index, key, grads in (
        ("flash_dq", "nos_tpu/ops/flash_attention.py:326", 1, "dq", ("dq",)),
        ("flash_dkv", "nos_tpu/ops/flash_attention.py:368", 2, "dkv", ("dk", "dv")),
    )], "seconds": time.time() - t_start, "card": card})
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
