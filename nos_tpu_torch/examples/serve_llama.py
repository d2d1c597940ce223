"""Serve a Llama checkpoint: the port of ``examples/serve_llama.py``.

    python -m nos_tpu_torch.examples.serve_llama [--real-weights DIR] [--device cpu]

The reference's serving stack step for step:

  1. int8 weight-only quantization (decode reads the weights every tick,
     so halving their bytes is what a token costs);
  2. under torchrun with an even world size, tensor-parallel serving of
     the int8 tree over the ranks' ``("dp", "tp")`` mesh
     (``shard_for_serving``, a head-sharded KV cache; the Engine serves
     on its tp line);
  3. the continuous-batching Engine multiplexing mixed-length requests
     that share a 40-token system prompt, with a prefix cache;
  4. without ``--real-weights``: a rolling sliding-window cache serving a
     stream far past its physical length, ``SpecEngine`` with a 1-layer
     draft, and multi-tenant LoRA over one base;
  5. one sampled ``generate`` with top-k / nucleus filtering.

``--real-weights DIR`` loads a Llama-family checkpoint directory
(``models/convert.py:load_hf_llama``); otherwise the model is the tiny
config from seed 0. Prompts and draws come from ``torch.Generator``s, so
the requests are not the reference's ``jax.random`` ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.examples import dp_tp_mesh, is_main_rank


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real-weights", default="")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config
    from nos_tpu_torch.models.quantize import quantize_params, weight_bytes
    from nos_tpu_torch.serve import Engine, GenRequest
    from nos_tpu_torch.util import metrics

    args = parser().parse_args(argv)
    device = _resolve_device(args.device)
    mesh = dp_tp_mesh(device)
    say = print if is_main_rank() else (lambda *a, **k: None)
    out = {}

    if args.real_weights:
        from nos_tpu_torch.models.convert import load_hf_llama

        params, config = load_hf_llama(args.real_weights, device=device)
    else:
        config = tiny_config()
        params = init_llama_params(config, seed=0, device=device)

    dense_bytes = weight_bytes(params)
    params = quantize_params(params)
    out["int8_bytes"], out["dense_bytes"] = weight_bytes(params), dense_bytes
    say(f"int8 weights: {out['int8_bytes'] / 1e6:.1f} MB "
        f"({out['int8_bytes'] / dense_bytes:.2f}x of bf16)")

    engine_params = params
    if mesh is not None:
        from nos_tpu_torch.serve import shard_for_serving

        engine_params = shard_for_serving(params, mesh, config)
        say(f"tensor-parallel over {mesh.shape} ranks "
            "(Megatron params + head-sharded KV cache)")

    engine = Engine(engine_params, config, max_slots=args.slots, max_len=args.max_len,
                    prefill_chunk=16, prefix_cache_entries=4, mesh=mesh)
    gen = torch.Generator().manual_seed(0)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen).tolist()

    # the requests share a system prompt: with the prefix cache on, only
    # the first admission prefills it
    system = randint(1, config.vocab_size, 40)
    ids = []
    for _ in range(args.slots * 2):
        n = randint(4, 24, 1)[0]
        prompt = system + randint(1, config.vocab_size, n)
        ids.append(engine.submit(GenRequest(prompt=prompt, max_new_tokens=16)))
    hits0 = metrics.SERVE_PREFIX_HITS.value
    start = time.perf_counter()
    with torch.no_grad():
        results = engine.run()
    wall = time.perf_counter() - start
    total = sum(len(t) for t in results.values())
    out["engine"] = {"requests": len(ids), "tokens": total, "seconds": wall,
                     "tokens_per_s": total / wall,
                     "prefix_hits": int(metrics.SERVE_PREFIX_HITS.value - hits0)}
    say(f"engine: {len(ids)} requests, {total} tokens in {wall:.2f}s "
        f"({total / wall:.1f} tok/s across {args.slots} slots, "
        f"{out['engine']['prefix_hits']} prefix-cache hits)")

    if not args.real_weights:
        out.update(_tiny_extensions(config, params, args, device, gen, say))

    with torch.no_grad():
        sampled = generate(
            params, torch.tensor([[1, 2, 3, 4]], device=device), config, 12,
            temperature=0.8, top_k=40, top_p=0.95,
            rng=torch.Generator(device=device).manual_seed(7),
        )
    out["sampled"] = sampled[0].tolist()
    say("sampled:", out["sampled"])
    return out


def _tiny_extensions(config, params, args, device, gen, say) -> dict:
    """The reference's demos that need the tiny model: rolling window,
    speculative batching, multi-tenant LoRA."""
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config
    from nos_tpu_torch.models.lora import LoraConfig, init_lora_params, stack_lora_adapters
    from nos_tpu_torch.serve import Engine, GenRequest, SpecEngine

    out = {}
    # rolling sliding-window cache: a stream far past the cache's
    # physical length from O(window) memory
    wcfg = dataclasses.replace(config, sliding_window=16)
    wparams = init_llama_params(wcfg, seed=4, device=device)
    roll = Engine(wparams, wcfg, max_slots=1, max_len=33, ticks_per_sync=8,
                  prefill_chunk=8, rolling=True)
    rid = roll.submit(GenRequest(prompt=[3, 1, 4, 1, 5] * 8, max_new_tokens=120))
    with torch.no_grad():
        n = len(roll.run()[rid])
    out["rolling_positions"] = 40 + n
    say(f"rolling window: {40 + n} logical positions served through a 33-slot "
        "cache (window 16)")

    # speculative continuous batching: a 1-layer draft proposes k = 4
    draft_cfg = tiny_config(n_layers=1)
    draft = init_llama_params(draft_cfg, seed=1, device=device)
    spec = SpecEngine(params, config, draft, draft_cfg, k=4, max_slots=2,
                      max_len=args.max_len)
    for _ in range(4):
        prompt = torch.randint(1, config.vocab_size, (12,), generator=gen).tolist()
        spec.submit(GenRequest(prompt=prompt, max_new_tokens=16))
    with torch.no_grad():
        spec.run()
    out["speculative"] = spec.stats()
    say(f"speculative engine: {out['speculative']['rounds']} rounds, mean accepted "
        f"{out['speculative']['mean_accepted']:.2f}/4 drafts per round")

    # multi-tenant LoRA: two adapters share the batch (0 = the bare base)
    lora = LoraConfig(rank=4)
    base = init_llama_params(config, seed=2, device=device)
    adapters = [init_lora_params(config, lora, seed=3 + i, device=device) for i in range(2)]
    stacked = stack_lora_adapters(base, adapters, lora, rows=2)
    ml = Engine(stacked, config, max_slots=2, max_len=64, ticks_per_sync=4)
    ids = [ml.submit(GenRequest(prompt=[5, 9, 2], max_new_tokens=8, adapter=a))
           for a in (0, 1, 2)]
    with torch.no_grad():
        done = ml.run()
    out["multi_lora_tokens"] = [len(done[i]) for i in ids]
    say(f"multi-LoRA: {len(ids)} co-tenant requests over adapters 0/1/2 -> "
        f"{out['multi_lora_tokens']} tokens each")
    return out


if __name__ == "__main__":
    main()
