"""Open-loop workload driver for the serving engines.

Port of ``nos_tpu/slo/driver.py``: the same public names, the same
arrival stream (``build_arrivals`` draws from ``random.Random(seed)``
in the reference's order) and the same report, over the port's
``Engine`` and ``serve/telemetry.py``.

Open loop: arrivals are a seeded Poisson process shaped by a diurnal
rate curve, generated up front as a pure function of the config, and
each request is stamped with its *arrival* time no matter when the
engine admits it, so queue wait and TTFT include scheduling delay under
overload (no coordinated omission).

Determinism: each engine runs on its own ``VirtualServeClock``; time
advances from the clock's cost model (seconds per decode tick, per
prefill token), not the host's wall clock, so every latency in the
report is a pure function of (seed, config, engine scheduling). The
constructor refuses any other clock. On the card the cost model can be
calibrated from measured step times (``slo/bench_serve.py --card``);
the report's latencies are then still virtual.

Model skew: each ``ModelProfile`` owns a share of the arrival stream,
and each model name maps to its own engine (a replica per model).

Each drive's loop is a registered target of the stack profiler
(``serve-<model>``, ``/debug/profile``), its samples attributed to the
engine's spans under ``serve.drive``.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from nos_tpu_torch.serve.engine import Engine, GenRequest
from nos_tpu_torch.serve.telemetry import RequestRecord, VirtualServeClock
from nos_tpu_torch.slo.engine import SLOEngine
from nos_tpu_torch.util.profiling import PROFILER
from nos_tpu_torch.util.tracing import TRACER


@dataclass(frozen=True)
class ModelProfile:
    """One model's share of the workload."""

    name: str
    weight: float = 1.0  # relative share of arrivals
    prompt_tokens: tuple = (8, 32)  # inclusive range
    max_new_tokens: tuple = (8, 48)  # inclusive range
    adapter: int = 0


@dataclass(frozen=True)
class WorkloadConfig:
    seed: int = 0
    duration_s: float = 60.0
    rate_rps: float = 2.0  # mean arrival rate across all models
    # rate(t) = rate_rps * (1 + amplitude * sin(2*pi*t/period)): 0 = flat,
    # 0.5 = peaks at 1.5x and troughs at 0.5x the mean.
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 60.0
    vocab: int = 256
    models: Sequence[ModelProfile] = field(
        default_factory=lambda: (ModelProfile(name="default"),)
    )


@dataclass(frozen=True)
class Arrival:
    t: float
    model: str
    prompt: List[int]
    max_new_tokens: int
    adapter: int = 0


def build_arrivals(config: WorkloadConfig) -> List[Arrival]:
    """The whole arrival schedule as a pure function of the config.

    Poisson process via thinning: draw candidates at the PEAK rate, keep
    each with probability rate(t)/peak — an exact non-homogeneous
    Poisson sampler, and the accept/reject draws stay aligned with the
    seed no matter how the rate curve moves.
    """
    if not config.models:
        raise ValueError("workload needs at least one ModelProfile")
    if not 0.0 <= config.diurnal_amplitude <= 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1]")
    rng = random.Random(config.seed)
    peak = config.rate_rps * (1.0 + config.diurnal_amplitude)
    if peak <= 0:
        return []
    weights = [max(0.0, m.weight) for m in config.models]
    total_w = sum(weights)
    if total_w <= 0:
        raise ValueError("model weights must sum to > 0")
    arrivals: List[Arrival] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= config.duration_s:
            break
        rate = config.rate_rps * (
            1.0
            + config.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / config.diurnal_period_s)
        )
        if rng.random() * peak > rate:
            continue  # thinned candidate; draws consumed, alignment kept
        pick = rng.random() * total_w
        model = config.models[-1]
        for m, w in zip(config.models, weights):
            pick -= w
            if pick < 0:
                model = m
                break
        n_prompt = rng.randint(*model.prompt_tokens)
        arrivals.append(
            Arrival(
                t=t,
                model=model.name,
                prompt=[rng.randrange(config.vocab) for _ in range(n_prompt)],
                max_new_tokens=rng.randint(*model.max_new_tokens),
                adapter=model.adapter,
            )
        )
    return arrivals


def percentiles(values: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 by the nearest-rank method (deterministic, no
    interpolation ambiguity across platforms)."""
    if not values:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    ordered = sorted(values)
    out = {}
    for p, key in ((50, "p50"), (95, "p95"), (99, "p99")):
        rank = max(1, math.ceil(p / 100.0 * len(ordered)))
        out[key] = round(ordered[rank - 1], 6)
    return out


class OpenLoopDriver:
    """Drives one engine per model through a shared arrival schedule.

    Each engine's telemetry must carry a ``VirtualServeClock`` (the
    constructor checks): it submits every arrival with
    ``submit_at`` = its generated arrival time, steps the engine while
    it is busy (the engine's cost model advances the clock), and jumps
    the clock forward over idle gaps. Replicas are independent, so
    models are driven to completion one at a time — the interleaving a
    shared wall clock would force does not exist in virtual time.
    """

    def __init__(
        self,
        engines: Dict[str, Engine],
        config: WorkloadConfig,
        slo: Optional[SLOEngine] = None,
    ) -> None:
        for profile in config.models:
            if profile.name not in engines:
                raise ValueError(f"no engine for model {profile.name!r}")
            clock = engines[profile.name].telemetry.clock
            if not isinstance(clock, VirtualServeClock):
                raise ValueError(
                    f"engine {profile.name!r} needs a VirtualServeClock "
                    "(wall-clock engines cannot produce a deterministic "
                    "report)"
                )
        self.engines = engines
        self.config = config
        self.slo = slo
        self.records: Dict[str, List[RequestRecord]] = {}

    # ------------------------------------------------------------ driving

    def _drive_one(self, model: str, arrivals: List[Arrival]) -> None:
        engine = self.engines[model]
        telemetry = engine.telemetry
        clock = telemetry.clock
        done_before = set(telemetry.completed)
        i = 0
        with PROFILER.registered(f"serve-{model}"), \
                TRACER.span("serve.drive", model=model, arrivals=len(arrivals)):
            while i < len(arrivals) or engine.busy:
                while i < len(arrivals) and arrivals[i].t <= clock.now():
                    a = arrivals[i]
                    engine.submit(
                        GenRequest(
                            prompt=list(a.prompt),
                            max_new_tokens=a.max_new_tokens,
                            adapter=a.adapter,
                        ),
                        submit_at=a.t,
                    )
                    i += 1
                if engine.busy:
                    engine.step(chunks=1)
                elif i < len(arrivals):
                    clock.advance_to(arrivals[i].t)
        self.records[model] = [
            rec
            for rid, rec in telemetry.completed.items()
            if rid not in done_before
        ]

    def run(self) -> Dict[str, Any]:
        arrivals = build_arrivals(self.config)
        by_model: Dict[str, List[Arrival]] = {
            m.name: [] for m in self.config.models
        }
        for a in arrivals:
            by_model[a.model].append(a)
        for model in sorted(by_model):
            self._drive_one(model, by_model[model])
        return self.report()

    # ---------------------------------------------------------- reporting

    @staticmethod
    def _stats(records: List[RequestRecord]) -> Dict[str, Any]:
        tokens = sum(r.tokens for r in records)
        good = [r for r in records if r.good]
        last_retire = max((r.retire_t or 0.0 for r in records), default=0.0)
        return {
            "requests": len(records),
            "tokens": tokens,
            "ttft_s": percentiles([r.ttft_s for r in records if r.ttft_s is not None]),
            "tpot_s": percentiles(
                [r.tpot_s for r in records if r.tpot_s is not None and r.tokens > 1]
            ),
            "e2e_s": percentiles([r.e2e_s for r in records if r.e2e_s is not None]),
            "queue_wait_s": percentiles(
                [r.queue_wait_s for r in records if r.queue_wait_s is not None]
            ),
            "goodput": {
                "good_requests": len(good),
                "request_fraction": round(len(good) / len(records), 6)
                if records
                else 0.0,
                "good_tokens": sum(r.tokens for r in good),
                "good_tokens_per_s": round(
                    sum(r.tokens for r in good) / last_retire, 6
                )
                if last_retire > 0
                else 0.0,
            },
        }

    def report(self) -> Dict[str, Any]:
        models = {
            model: self._stats(records)
            for model, records in sorted(self.records.items())
        }
        everything = [r for records in self.records.values() for r in records]
        out: Dict[str, Any] = {
            "workload": {
                "seed": self.config.seed,
                "duration_s": self.config.duration_s,
                "rate_rps": self.config.rate_rps,
                "diurnal_amplitude": self.config.diurnal_amplitude,
                "diurnal_period_s": self.config.diurnal_period_s,
                "models": [
                    {
                        "name": m.name,
                        "weight": m.weight,
                        "prompt_tokens": list(m.prompt_tokens),
                        "max_new_tokens": list(m.max_new_tokens),
                    }
                    for m in self.config.models
                ],
            },
            "models": models,
            "aggregate": self._stats(everything),
        }
        if self.slo is not None:
            # Evaluate at the latest per-replica virtual instant: every
            # replica's whole run lands inside the slow window.
            now = max(
                (e.telemetry.clock.now() for e in self.engines.values()),
                default=0.0,
            )
            evaluation = self.slo.evaluate(now=now)
            out["slo"] = {
                "specs": [s["spec"] for s in evaluation["slos"]],
                "verdicts": {
                    s["slo"]: {
                        "compliant": s["compliant"],
                        "burn_rate_fast": s["fast"]["burn_rate"],
                        "burn_rate_slow": s["slow"]["burn_rate"],
                        "error_budget_remaining": s["error_budget_remaining"],
                    }
                    for s in evaluation["slos"]
                },
            }
        return out
