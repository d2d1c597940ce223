"""Time decode steps of a full-width model on the card, per weight format.

    python3 -m nos_tpu_torch.models.decode_bench [--formats bf16,int8,int4]
        [--kv bf16,int8]

Llama-3-8B (``llama_3_8b_config()``, all 32 layers, flash prefill) with
random weights from a seed: one prefill of [2, 512], then 16 decode
steps after two warm-ups, timed on the host clock around a synchronised
loop (decode is host-bound: the clock that counts is the caller's). One
JSON line per (weight format, cache kind) with the card's name and power
limit. Only ``--formats bf16 --kv bf16`` is used when the script is
copied into a checkout that predates the quantized formats, so that two
checkouts can be compared in one call (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

BATCH, PROMPT, STEPS = 2, 512, 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_decode(params, cfg, prompt, first, kv_quant: bool, steps: int = 16,
                max_len=None):
    """(ms per decode step, ``run(n)``): a prefill of ``prompt`` into a
    cache of ``max_len`` (default prompt + steps + 2), two warm-up steps
    from ``first`` [B], then ``steps`` timed ones; ``run(n)`` runs n more
    from the same token and position (for a profiler)."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod

    s = prompt.shape[1]
    quant = {"quant": True} if kv_quant else {}
    _, cache = gen_mod.prefill(params, prompt, cfg, max_len or s + steps + 2, **quant)

    def run(n):
        token = first
        for i in range(n):
            logits, _ = gen_mod.decode_step(params, cache, s + i, token, cfg)
            token = logits.argmax(dim=-1)
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run(steps)
    return (time.perf_counter() - t0) / steps * 1e3, run


def main() -> None:
    import torch

    from nos_tpu_torch.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", default="bf16,int8,int4")
    ap.add_argument("--kv", default="bf16,int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench needs a CUDA device")
    card = card_line()
    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    first = torch.randint(1, cfg.vocab_size, (BATCH,), generator=gen, device="cuda")
    for fmt in args.formats.split(","):
        tree = params
        if fmt != "bf16":
            from nos_tpu_torch.models import quantize as tq

            tree = (tq.quantize_params(params) if fmt == "int8"
                    else tq.quantize_params_int4(params, group=128))
        for kv in args.kv.split(","):
            with torch.no_grad():
                ms, _ = time_decode(tree, cfg, prompt, first, kv == "int8", STEPS)
            print(json.dumps({"bench": "decode", "weights": fmt, "kv_cache": kv,
                              "batch": BATCH, "cache_len": PROMPT + STEPS + 2,
                              "layers": cfg.n_layers, "ms_per_step": ms,
                              "card": card}), flush=True)
        del tree


if __name__ == "__main__":
    main()
