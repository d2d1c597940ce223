"""Serving SLO benchmark: an open-loop workload against the port's Engine.

Counterpart of the repository's ``bench_serve.py``, with the same default
objectives, engine settings (4 slots, max_len 256, 8 ticks a sync,
16-token prefill chunks), hot / cold profiles (0.8 / 0.2 of a seeded
Poisson stream with diurnal shaping), flags and report:

  ttft_s / tpot_s / e2e_s / queue_wait_s  p50/p95/p99, per model + aggregate
  goodput                                 requests/tokens that met the
                                          SLO-derived latency targets
  slo.verdicts                            per-SLO fast/slow burn rate,
                                          compliance, budget remaining

Latencies come from each engine's ``VirtualServeClock``, so on the CPU
(tiny Llama, ``--device cpu``) the report is a pure function of the seed,
the workload and the engine's scheduling, and equals the reference's
number for number (its requests carry no ``eos_id``, so no token value
changes the schedule).

``--card --checkpoint DIR`` serves Llama-3-8B (or any Llama-family
checkpoint directory) on the GPU: it measures one batched decode tick
with 4 active slots and one 16-token prefill chunk (host wall time with
the device synchronised, medians), gives them to the virtual clock as
its ``tick_cost_s`` / ``prefill_token_cost_s``, and drives the workload.
Its latencies are still virtual, from a clock calibrated on the card,
not a wall clock; the report's ``clock`` block says so, and its ``wall``
block carries the drive's own wall seconds and tokens/s.

  python -m nos_tpu_torch.slo.bench_serve --device cpu --smoke
  python -m nos_tpu_torch.slo.bench_serve --card --checkpoint DIR
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.models.llama import init_llama_params, tiny_config
from nos_tpu_torch.serve.engine import Engine
from nos_tpu_torch.serve.telemetry import ServeTelemetry, VirtualServeClock
from nos_tpu_torch.slo.driver import ModelProfile, OpenLoopDriver, WorkloadConfig
from nos_tpu_torch.slo.engine import SLOEngine

# The reference's default objectives (bench_serve.py). With its virtual
# cost model (8 ms a batched decode tick, 0.2 ms a prefill token) TPOT is
# about 8 ms and an unqueued TTFT about 75 ms.
DEFAULT_SLOS = (
    "p95 ttft < 500ms",
    "p99 e2e < 3s",
    "p50 tpot < 20ms",
    "availability 99%",
)
SLOTS, MAX_LEN, TICKS_PER_SYNC, PREFILL_CHUNK = 4, 256, 8, 16
CALIBRATION_REPS = 7


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise RuntimeError(f"--card measures the GPU; this run is on {device}")


def calibrate(params, model_config) -> dict:
    """Seconds of one batched decode tick (``SLOTS`` active rows, as
    the Engine runs them) and of one ``PREFILL_CHUNK``-token prefill
    chunk (chunked admission's piece), each the median of ``CALIBRATION_REPS`` runs
    of host wall time with the device synchronised, after a warm-up.
    Measures the card only: params on another device raise."""
    from nos_tpu_torch.models.generate import decode_chunk, decode_step, init_kv_cache
    from nos_tpu_torch.models.llama import params_device

    dev = params_device(params)
    _check_card(dev)
    cfg = model_config
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, SLOTS, MAX_LEN, device=dev)
    row = init_kv_cache(cfg, 1, MAX_LEN + 1, device=dev)
    depth = 64  # each row's frontier mid-cache
    pos = torch.full((SLOTS,), depth, dtype=torch.long, device=dev)
    key_valid = torch.zeros((SLOTS, MAX_LEN), dtype=torch.bool, device=dev)
    key_valid[:, :depth + TICKS_PER_SYNC] = True
    last = torch.randint(1, cfg.vocab_size, (SLOTS,), generator=gen, device=dev)
    piece = torch.randint(1, cfg.vocab_size, (1, PREFILL_CHUNK), generator=gen, device=dev)
    mask = torch.ones((1, PREFILL_CHUNK), dtype=torch.bool, device=dev)
    start = torch.zeros((1,), dtype=torch.long, device=dev)

    def ticks():
        p, tok = pos, last
        for _ in range(TICKS_PER_SYNC):
            logits, _ = decode_step(params, cache, p, tok, cfg, rope_pos=p,
                                    key_valid=key_valid)
            tok = logits.argmax(dim=-1)
            p = p + 1

    def chunk():
        decode_chunk(params, row, start, piece, cfg, write_mask=mask)

    def median_s(fn, per: int) -> list:
        samples = []
        with torch.no_grad():
            fn()
            _sync(dev)
            for _ in range(CALIBRATION_REPS):
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                samples.append((time.perf_counter() - t0) / per)
        return samples

    tick_s = median_s(ticks, TICKS_PER_SYNC)
    chunk_s = median_s(chunk, 1)
    return {
        "tick_cost_s": statistics.median(tick_s),
        "prefill_token_cost_s": statistics.median(chunk_s) / PREFILL_CHUNK,
        "tick_s_samples": tick_s,
        "prefill_chunk_s_samples": chunk_s,
        "slots": SLOTS, "max_len": MAX_LEN, "prefill_chunk": PREFILL_CHUNK,
    }


def build_engines(config: WorkloadConfig, slo: SLOEngine, params=None, model_config=None,
                  clock_costs: Optional[dict] = None, device=None):
    """One replica per model profile, all over one params tree (the skew
    under test is traffic, not parameters), each on its own virtual
    clock (``clock_costs``: its tick / prefill-token seconds, else the
    reference's defaults) with goodput targets from the SLO specs.
    ``params`` / ``model_config``: by default the tiny Llama from seed 0
    on ``device``."""
    if model_config is None:
        model_config = tiny_config()
    if params is None:
        params = init_llama_params(model_config, seed=0, device=device)
    costs = {k: clock_costs[k] for k in ("tick_cost_s", "prefill_token_cost_s")} \
        if clock_costs else {}
    targets = slo.latency_targets()
    engines = {}
    for profile in config.models:
        telemetry = ServeTelemetry(
            model=profile.name,
            clock=VirtualServeClock(**costs),
            ttft_target_s=targets.get("ttft"),
            e2e_target_s=targets.get("e2e"),
            on_complete=slo.record,
        )
        engines[profile.name] = Engine(
            params, model_config, max_slots=SLOTS, max_len=MAX_LEN,
            ticks_per_sync=TICKS_PER_SYNC,
            # prompts above 16 tokens take the chunked-admission path, so
            # the bench exercises both prefill paths every run
            prefill_chunk=PREFILL_CHUNK, model=profile.name, telemetry=telemetry,
        )
    return engines


def workload(args: argparse.Namespace) -> WorkloadConfig:
    return WorkloadConfig(
        seed=args.seed,
        duration_s=args.duration,
        rate_rps=args.rate,
        diurnal_amplitude=0.5,
        diurnal_period_s=args.duration,
        models=(
            ModelProfile(name="hot", weight=0.8, prompt_tokens=(8, 32),
                         max_new_tokens=(8, 48)),
            ModelProfile(name="cold", weight=0.2, prompt_tokens=(8, 32),
                         max_new_tokens=(8, 48)),
        ),
    )


def run(args: argparse.Namespace, params=None, model_config=None) -> dict:
    """The report of one drive. ``args.card``: ``params`` (or the
    checkpoint at ``args.checkpoint``) on the card, the clock calibrated
    there first."""
    config = workload(args)
    slo = SLOEngine(list(args.slo), fast_window_s=args.duration / 4.0,
                    slow_window_s=args.duration * 2.0)
    costs = None
    device = _resolve_device(args.device)
    if args.card:
        _check_card(device)
        if params is None:
            from nos_tpu_torch.models.convert import load_hf_llama

            if not args.checkpoint:
                raise ValueError("--card needs --checkpoint DIR (a Llama-family checkpoint)")
            params, model_config = load_hf_llama(args.checkpoint, device=device)
        costs = calibrate(params, model_config)
    engines = build_engines(config, slo, params, model_config, costs, device)
    driver = OpenLoopDriver(engines, config, slo=slo)
    t0 = time.perf_counter()
    with torch.no_grad():
        report = driver.run()
    _sync(device)
    wall = time.perf_counter() - t0
    tokens = report["aggregate"]["tokens"]
    report["wall"] = {"drive_s": wall, "tokens_per_s": tokens / wall if wall > 0 else 0.0,
                      "device": str(device)}
    if costs is not None:
        report["clock"] = dict(
            costs, kind="virtual, calibrated on the card",
            card=torch.cuda.get_device_name(device),
            note="latencies come from a virtual clock whose tick and prefill costs "
                 "were measured on the card, not from a wall clock",
        )
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=120.0,
                   help="virtual seconds of arrivals")
    p.add_argument("--rate", type=float, default=8.0,
                   help="mean arrival rate (requests / virtual second)")
    p.add_argument("--slo", action="append", default=None,
                   help="SLO spec (repeatable); default: %s" % (DEFAULT_SLOS,))
    p.add_argument("--output", default=None, help="write JSON here")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for the serve-smoke tier (~60 requests)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.add_argument("--card", action="store_true",
                   help="serve --checkpoint on the GPU, the clock calibrated there")
    p.add_argument("--checkpoint", default="", help="checkpoint directory for --card")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = parser().parse_args(argv)
    if args.slo is None:
        args.slo = list(DEFAULT_SLOS)
    if args.smoke:
        args.duration = min(args.duration, 20.0)
        args.rate = min(args.rate, 3.0)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    report = run(args)
    body = json.dumps(report, indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(body + "\n")
    print(body)
    return report


if __name__ == "__main__":
    main()
