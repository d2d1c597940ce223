"""LoRA fine-tune, merge, serve int8: the port of ``examples/finetune_lora.py``.

    python -m nos_tpu_torch.examples.finetune_lora [--real-weights DIR] [--device cpu]

The slice tenant's fine-tuning story end to end, as the reference tells it:

  1. load a base model (a Llama-family checkpoint directory with
     ``--real-weights``, else the tiny config from seed 0);
  2. train rank-r adapters on wq / wv with the frozen-base LoRA step
     (Adam at 3e-3), over the ranks' ``("dp", "tp")`` mesh under
     torchrun with an even world size (the base sharded, the adapters
     whole on every rank), on one device otherwise;
  3. merge the adapters into a dense tree;
  4. quantize it to int8 and generate from the artifact.

Tokens come from ``torch.Generator``s, not the reference's ``jax.random``.
"""
from __future__ import annotations

import argparse

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.examples import dp_tp_mesh, is_main_rank


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real-weights", default="")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config, tree_leaves
    from nos_tpu_torch.models.lora import (
        LoraConfig,
        init_lora_params,
        make_lora_train_step,
        merge_lora,
    )
    from nos_tpu_torch.models.quantize import quantize_params
    from nos_tpu_torch.parallel.sharding import llama_data_sharding, shard_params

    args = parser().parse_args(argv)
    device = _resolve_device(args.device)
    mesh = dp_tp_mesh(device)
    say = print if is_main_rank() else (lambda *a, **k: None)

    if args.real_weights:
        from nos_tpu_torch.models.convert import load_hf_llama

        params, config = load_hf_llama(args.real_weights, device=device)
    else:
        config = tiny_config()
        params = init_llama_params(config, seed=0, device=device)
    base = params if mesh is None else shard_params(params, mesh, config)

    lora = LoraConfig(rank=args.rank)
    step, shard = make_lora_train_step(mesh, config, lora, learning_rate=3e-3, device=device)
    state = shard(init_lora_params(config, lora, seed=1, device=device))

    n_base = sum(t.numel() for t in tree_leaves(params))
    n_lora = sum(t.numel() for t in tree_leaves(state[0]))
    say(f"trainable: {n_lora:,} of {n_base:,} params ({100.0 * n_lora / n_base:.2f}%)")

    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, config.vocab_size, (8, 32), generator=gen, device=device)
    if mesh is not None:
        tokens = llama_data_sharding(mesh, tokens)
    losses = []
    for i in range(args.steps):
        state, loss = step(state, base, tokens)
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            say(f"step {i:3d}  loss {float(loss):.4f}")

    with torch.no_grad():
        merged = merge_lora(params, state[0], lora)
        artifact = quantize_params(merged)
        out = generate(artifact, torch.tensor([[1, 2, 3, 4]], device=device), config, 12)
    say("int8 serve of the fine-tuned artifact:", out[0].tolist())
    return {"trainable": n_lora, "base": n_base,
            "losses": [float(x) for x in losses], "tokens": out[0].tolist()}


if __name__ == "__main__":
    main()
