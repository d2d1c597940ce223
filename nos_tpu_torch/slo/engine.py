"""Burn-rate SLO engine over the serving telemetry.

Port of ``nos_tpu/slo/engine.py`` (the same public names, specs and
arithmetic), over the port's ``serve/telemetry.py`` records and its own
metrics registry (``nos_tpu_torch/util/metrics.py``), under the
reference's metric names. The reference cannot be borrowed: importing
``nos_tpu.slo`` loads ``nos_tpu.serve`` and so JAX.

An SLO is a target fraction of good events (multi-window multi-burn-rate,
Google SRE workbook); the error budget is the allowed bad fraction, and
the burn rate over a window is

    burn = bad_fraction(window) / (1 - objective)

so burn 1.0 exactly exhausts the budget at the window's scale.

Specs are declarative one-liners:

- ``"p95 ttft < 300ms"``: 95% of requests must see TTFT under 300 ms.
  Metric is one of ``ttft``/``tpot``/``e2e``/``queue_wait``; the
  percentile is the objective (a request over the threshold is a bad
  event).
- ``"availability 99.9%"``: 99.9% of requests must be *good* in the
  goodput sense (met the engine's per-request latency targets; see
  serve/telemetry.py).

Every completed request is one event per spec. ``evaluate()`` walks the
bounded record window once and publishes ``nos_tpu_slo_burn_rate
{slo,window}``, ``nos_tpu_slo_compliant{slo}`` and
``nos_tpu_slo_error_budget_remaining{slo}``; ``debug_payload()`` is the
rollup with the recent violations, each naming its journey's trace id.
"""
from __future__ import annotations

import re
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from nos_tpu_torch.serve.telemetry import RequestRecord, ServeClock
from nos_tpu_torch.util.metrics import REGISTRY

SLO_BURN_RATE = REGISTRY.gauge(
    "nos_tpu_slo_burn_rate",
    "Error-budget burn rate per SLO and window (by slo, window=fast|slow): "
    "bad fraction / allowed bad fraction — 1.0 burns exactly the budget, "
    "sustained >1.0 on the slow window means non-compliance",
)
SLO_COMPLIANT = REGISTRY.gauge(
    "nos_tpu_slo_compliant",
    "1 when the SLO's slow-window good fraction meets its objective "
    "(vacuously compliant with no traffic in the window) (by slo)",
)
SLO_BUDGET_REMAINING = REGISTRY.gauge(
    "nos_tpu_slo_error_budget_remaining",
    "Fraction of the slow-window error budget not yet consumed "
    "(1 - burn rate, clamped to [0, 1]) (by slo)",
)

# Latency metrics a spec may target — properties of RequestRecord.
_METRICS = ("ttft", "tpot", "e2e", "queue_wait")

_LATENCY_RE = re.compile(
    r"^p(?P<pct>\d{1,2}(?:\.\d+)?)\s+(?P<metric>[a-z][a-z0-9_]*)\s*<\s*"
    r"(?P<value>\d+(?:\.\d+)?)\s*(?P<unit>ms|s)$"
)
_AVAIL_RE = re.compile(r"^availability\s+(?P<pct>\d{1,2}(?:\.\d+)?)%$")


@dataclass(frozen=True)
class SLOSpec:
    """One parsed objective. ``metric`` is a latency name or
    ``"availability"``; latency specs carry the threshold whose
    violation makes a request a bad event."""

    raw: str
    name: str
    metric: str
    objective: float  # required good fraction, e.g. 0.95
    threshold_s: Optional[float] = None  # latency specs only

    @staticmethod
    def parse(text: str) -> "SLOSpec":
        spec = text.strip().lower()
        m = _LATENCY_RE.match(spec)
        if m:
            metric = m.group("metric")
            if metric not in _METRICS:
                raise ValueError(
                    f"unknown SLO metric {metric!r}: pick one of "
                    f"{', '.join(_METRICS)}"
                )
            pct = float(m.group("pct"))
            if not 0 < pct < 100:
                raise ValueError(f"percentile must be in (0, 100): {text!r}")
            value = float(m.group("value"))
            threshold = value / 1000.0 if m.group("unit") == "ms" else value
            unit = m.group("unit")
            shown = f"{value:g}{unit}"
            return SLOSpec(
                raw=text.strip(),
                name=f"{metric}_p{m.group('pct')}_lt_{shown}",
                metric=metric,
                objective=pct / 100.0,
                threshold_s=threshold,
            )
        m = _AVAIL_RE.match(spec)
        if m:
            pct = float(m.group("pct"))
            if not 0 < pct < 100:
                raise ValueError(f"availability must be in (0, 100): {text!r}")
            return SLOSpec(
                raw=text.strip(),
                name=f"availability_{m.group('pct')}",
                metric="availability",
                objective=pct / 100.0,
            )
        raise ValueError(
            f"unparseable SLO {text!r}: expected 'p<pct> "
            f"<ttft|tpot|e2e|queue_wait> < <n><ms|s>' or "
            f"'availability <pct>%'"
        )

    def is_bad(self, event: "_Event") -> bool:
        if self.metric == "availability":
            return not event.ok
        value = event.metrics.get(self.metric)
        # A stage that never happened (no first token, etc.) is bad: the
        # user saw the miss either way.
        return value is None or value > self.threshold_s


@dataclass(frozen=True)
class _Event:
    t: float
    metrics: Dict[str, Optional[float]]
    ok: bool
    trace_id: str


class SLOEngine:
    """Windowed burn-rate evaluator over completed-request events.

    Feed it retired requests (``record``; the engine telemetry's
    ``on_complete`` callback is the natural wire) and call ``evaluate``
    periodically — every call re-publishes the SLO gauges and returns
    the rollup dict (the document the reference serves at ``/debug/slo``).
    """

    MAX_VIOLATIONS = 32

    def __init__(
        self,
        specs: Sequence["SLOSpec | str"],
        clock: Optional[ServeClock] = None,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        max_records: int = 65536,
    ) -> None:
        self.specs: List[SLOSpec] = [
            s if isinstance(s, SLOSpec) else SLOSpec.parse(s) for s in specs
        ]
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self.clock = clock or ServeClock()
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self._events: "deque[_Event]" = deque(maxlen=max_records)
        self._violations: "deque[dict]" = deque(maxlen=self.MAX_VIOLATIONS)
        self._seen = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ intake

    def latency_targets(self) -> Dict[str, float]:
        """Tightest latency threshold per metric — what the engine's
        goodput targets (ServeTelemetry ttft_target_s / e2e_target_s)
        should be set to so 'good' and 'available' agree."""
        targets: Dict[str, float] = {}
        for spec in self.specs:
            if spec.threshold_s is None:
                continue
            prev = targets.get(spec.metric)
            if prev is None or spec.threshold_s < prev:
                targets[spec.metric] = spec.threshold_s
        return targets

    def record(self, rec: RequestRecord) -> None:
        """One retired request becomes one event per SLO."""
        event = _Event(
            t=rec.retire_t if rec.retire_t is not None else self.clock.now(),
            metrics={
                "ttft": rec.ttft_s,
                "tpot": rec.tpot_s,
                "e2e": rec.e2e_s,
                "queue_wait": rec.queue_wait_s,
            },
            ok=bool(rec.good),
            trace_id=rec.trace_id,
        )
        violated = [s.name for s in self.specs if s.is_bad(event)]
        with self._lock:
            self._seen += 1
            self._events.append(event)
            if violated:
                entry = {
                    "t": round(event.t, 6),
                    "request": rec.id,
                    "model": rec.model,
                    "slos": violated,
                    "ttft_s": round(event.metrics["ttft"] or 0.0, 6),
                    "e2e_s": round(event.metrics["e2e"] or 0.0, 6),
                }
                if event.trace_id:
                    entry["trace"] = f"/debug/traces?id={event.trace_id}"
                self._violations.append(entry)

    # -------------------------------------------------------- evaluation

    def _window_stats(
        self, spec: SLOSpec, events: List[_Event], now: float, window_s: float
    ) -> Dict[str, Any]:
        total = bad = 0
        for event in events:
            if event.t > now - window_s:
                total += 1
                if spec.is_bad(event):
                    bad += 1
        allowed = 1.0 - spec.objective
        bad_fraction = bad / total if total else 0.0
        burn = bad_fraction / allowed if allowed > 0 else 0.0
        return {
            "requests": total,
            "bad": bad,
            "bad_fraction": round(bad_fraction, 6),
            "burn_rate": round(burn, 6),
        }

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Re-evaluate every spec over both windows, publish the gauges,
        and return the per-SLO rollup (the ``/debug/slo`` document sans
        violation feed)."""
        if now is None:
            now = self.clock.now()
        with self._lock:
            events = list(self._events)
            seen = self._seen
        out: Dict[str, Any] = {
            "now": round(now, 6),
            "windows": {"fast_s": self.fast_window_s, "slow_s": self.slow_window_s},
            "requests_seen": seen,
            "slos": [],
        }
        for spec in self.specs:
            fast = self._window_stats(spec, events, now, self.fast_window_s)
            slow = self._window_stats(spec, events, now, self.slow_window_s)
            compliant = slow["burn_rate"] <= 1.0
            budget_remaining = round(
                min(1.0, max(0.0, 1.0 - slow["burn_rate"])), 6
            )
            SLO_BURN_RATE.labels(slo=spec.name, window="fast").set(
                fast["burn_rate"]
            )
            SLO_BURN_RATE.labels(slo=spec.name, window="slow").set(
                slow["burn_rate"]
            )
            SLO_COMPLIANT.labels(slo=spec.name).set(1.0 if compliant else 0.0)
            SLO_BUDGET_REMAINING.labels(slo=spec.name).set(budget_remaining)
            out["slos"].append(
                {
                    "slo": spec.name,
                    "spec": spec.raw,
                    "metric": spec.metric,
                    "objective": spec.objective,
                    "threshold_s": spec.threshold_s,
                    "fast": fast,
                    "slow": slow,
                    "compliant": compliant,
                    "error_budget_remaining": budget_remaining,
                }
            )
        return out

    def debug_payload(self) -> Dict[str, Any]:
        """The reference's ``/debug/slo`` document: live rollup + recent
        violations, each with its ``/debug/traces`` link."""
        payload = self.evaluate()
        with self._lock:
            payload["recent_violations"] = list(self._violations)
        return payload
