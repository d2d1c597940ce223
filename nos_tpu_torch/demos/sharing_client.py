"""Benchmark client: keeps a GPU, a MIG instance or an MPS share busy with
inference and reports its latency.

Counterpart of ``demos/tpu-sharing-comparison/client/main.py`` (the
reference's demos/gpu-sharing-comparison/client/main.py): a loop that runs
a vision model without pause and prints one JSON line of latency figures
every REPORT_WINDOW_SECONDS. BATCH_SIZE and IMAGE_SIZE default to the
reference's 8 and 224. On the card the model is ResNet-50 (bf16,
channels_last, random weights from a seed): the reference's tiny net would
measure only the host on an H100. ``--device cpu`` runs
``tiny_resnet_config()``, the reference's model. Images are drawn from the
same seed (the reference feeds zeros, on which every image gives the same
logits).

    python3 -m nos_tpu_torch.demos.sharing_client [--device cpu]

The same program runs on a whole GPU, a MIG instance (CUDA_VISIBLE_DEVICES
set to its UUID) or an MPS share: which one is the point of the comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SEED = 0


def build(device: str, batch: int, image: int):
    """(infer, config): ``infer()`` runs one forward of a fresh batch
    and returns its logits once the device is done. Weights and images
    are drawn from SEED."""
    import torch

    from nos_tpu_torch.models.resnet import (
        ResNetConfig,
        init_resnet_params,
        resnet_forward,
        tiny_resnet_config,
    )

    dev = torch.device(device)
    config = ResNetConfig() if dev.type == "cuda" else tiny_resnet_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_resnet_params(gen, config, device=dev)
    images = torch.randn((batch, image, image, 3), generator=gen, device=dev)

    def infer():
        with torch.no_grad():
            logits = resnet_forward(params, images, config)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return logits

    return infer, config


def timed(infer) -> float:
    start = time.monotonic()
    infer()
    return time.monotonic() - start


def summary(latencies, batch: int, seconds: float) -> dict:
    return {"inferences": len(latencies),
            "avg_s": statistics.fmean(latencies) if latencies else None,
            "p50_s": statistics.median(latencies) if latencies else None,
            "images_per_s": len(latencies) * batch / seconds}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    window = float(os.environ.get("REPORT_WINDOW_SECONDS", "10"))
    batch = int(os.environ.get("BATCH_SIZE", "8"))
    image = int(os.environ.get("IMAGE_SIZE", "224"))
    infer, _ = build(args.device, batch, image)
    infer()  # first call outside the windows
    latencies = []
    window_start = time.monotonic()
    while True:
        latencies.append(timed(infer))
        now = time.monotonic()
        if now - window_start >= window:
            print(json.dumps({"device": args.device,
                              **summary(latencies, batch, now - window_start)}), flush=True)
            latencies.clear()
            window_start = now


if __name__ == "__main__":
    sys.exit(main())
