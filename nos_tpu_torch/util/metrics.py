"""Prometheus-text metrics registry: the port's own trimmed copy.

Keeps what the serving engine and its telemetry use from
``nos_tpu/util/metrics.py``: counters, gauges and histograms as label
families (``counter.labels(model="m")`` returns a child series), a
get-or-create registry with text exposition, and the ``SERVE_*``
families. The reference's cardinality governor, child deletion,
percentile windows and incremental snapshot cursors serve its control
plane and are left out.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{key}="{escape_label_value(value)}"' for key, value in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Family:
    """Label-family plumbing shared by every metric type: a parent holds
    children keyed by their sorted label items."""

    def __init__(self, name: str, help_text: str, label_values=None) -> None:
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._label_values: Dict[str, str] = dict(label_values or {})
        self._children: Dict[Tuple, "_Family"] = {}

    def _new_child(self, label_values: Dict[str, str]) -> "_Family":
        raise NotImplementedError

    def labels(self, **label_values: str):
        """Child series for this label set (created on first use)."""
        if self._label_values:
            raise ValueError(f"{self.name}: labels() on an already-labeled child")
        key = tuple(sorted((k, str(v)) for k, v in label_values.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child({k: str(v) for k, v in label_values.items()})
                self._children[key] = child
            return child

    def _sorted_children(self):
        with self._lock:
            return [child for _, child in sorted(self._children.items())]


class Counter(_Family):
    TYPE = "counter"

    def __init__(self, name: str, help_text: str, label_values=None) -> None:
        super().__init__(name, help_text, label_values)
        self._value = 0.0

    def _new_child(self, label_values):
        return type(self)(self.name, self.help, label_values)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.TYPE}"]
        for series in [self] + self._sorted_children():
            lines.append(
                f"{series.name}{render_labels(series._label_values)} {series.value}"
            )
        return "\n".join(lines) + "\n"


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class Histogram(_Family):
    DEFAULT_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name: str, help_text: str,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 label_values=None) -> None:
        super().__init__(name, help_text, label_values)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def _new_child(self, label_values):
        return Histogram(self.name, self.help, self.buckets, label_values)

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _sample_lines(self) -> list:
        with self._lock:
            base = dict(self._label_values)
            lines = []
            cumulative = 0
            for bound, count in zip(self.buckets, self._counts):
                cumulative += count
                lines.append(
                    f"{self.name}_bucket{render_labels({**base, 'le': str(bound)})} "
                    f"{cumulative}"
                )
            cumulative += self._counts[-1]
            lines.append(
                f"{self.name}_bucket{render_labels({**base, 'le': '+Inf'})} {cumulative}"
            )
            lines.append(f"{self.name}_sum{render_labels(base)} {self._sum}")
            lines.append(f"{self.name}_count{render_labels(base)} {self._count}")
            return lines

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for series in [self] + self._sorted_children():
            lines.extend(series._sample_lines())
        return "\n".join(lines) + "\n"


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_text, buckets))

    def _get_or_create(self, name: str, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return "".join(m.render() for m in metrics)


# The process-wide registry of the port.
REGISTRY = MetricsRegistry()

# Serving engine.
SERVE_REQUESTS = REGISTRY.counter(
    "nos_tpu_serve_requests_total", "Requests completed by the serving engine"
)
SERVE_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_tokens_total", "Tokens generated by the serving engine"
)
SERVE_TICKS = REGISTRY.counter(
    "nos_tpu_serve_decode_ticks_total",
    "Batched decode ticks executed (each reads the weights once)",
)
SERVE_SLOT_TICKS_ACTIVE = REGISTRY.counter(
    "nos_tpu_serve_slot_ticks_active_total",
    "Per-slot ticks spent on live requests (active / (ticks*slots) = "
    "batch occupancy)",
)
SERVE_PREFIX_HITS = REGISTRY.counter(
    "nos_tpu_serve_prefix_cache_hits_total",
    "Chunked admissions that reused a cached prompt-prefix K/V",
)
SERVE_PREFIX_TOKENS_REUSED = REGISTRY.counter(
    "nos_tpu_serve_prefix_tokens_reused_total",
    "Prompt tokens whose prefill was skipped via the prefix cache",
)
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "nos_tpu_serve_queue_depth", "Requests waiting for a free slot"
)
SERVE_SLOTS = REGISTRY.gauge(
    "nos_tpu_serve_slots", "Configured slot count (the occupancy denominator)"
)

# Per-request serving latency (serve/telemetry.py), observed at retire,
# labeled model/adapter/bucket.
_SERVE_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
SERVE_TTFT = REGISTRY.histogram(
    "nos_tpu_serve_ttft_seconds",
    "Time to first token: submit to the first token EMITTED to the host "
    "(by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_TPOT = REGISTRY.histogram(
    "nos_tpu_serve_tpot_seconds",
    "Time per output token: (last token - first token) / (tokens - 1) "
    "(by model, adapter, bucket)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
SERVE_E2E = REGISTRY.histogram(
    "nos_tpu_serve_e2e_seconds",
    "End-to-end request latency, submit to retire (by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_QUEUE_WAIT = REGISTRY.histogram(
    "nos_tpu_serve_queue_wait_seconds",
    "Submit-to-admission wait for a free slot (by model, adapter, bucket)",
    buckets=_SERVE_LATENCY_BUCKETS,
)
SERVE_REQUEST_TOKENS_PER_S = REGISTRY.histogram(
    "nos_tpu_serve_request_tokens_per_second",
    "Per-request decode throughput: tokens / e2e latency "
    "(by model, adapter, bucket)",
    buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0),
)
SERVE_GOODPUT_REQUESTS = REGISTRY.counter(
    "nos_tpu_serve_goodput_requests_total",
    "Completed requests by latency verdict (verdict=good|late) (by model)",
)
SERVE_GOODPUT_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_goodput_tokens_total",
    "Tokens from requests that met their latency targets (by model)",
)

# Speculative decoding (serve/spec_engine.py): acceptance telemetry. The
# accept rate is accepted / draft; accepted / rounds over active
# row-rounds is stats()['mean_accepted'].
SERVE_SPEC_ROUNDS = REGISTRY.counter(
    "nos_tpu_serve_spec_rounds_total",
    "Speculative rounds executed per active row (row-rounds): each drafts "
    "k tokens and commits 1..k+1",
)
SERVE_SPEC_DRAFT_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_spec_draft_tokens_total",
    "Draft tokens proposed to the target verifier (k per active row-round)",
)
SERVE_SPEC_ACCEPTED_TOKENS = REGISTRY.counter(
    "nos_tpu_serve_spec_accepted_tokens_total",
    "Draft tokens the target accepted (committed - 1 per active row-round; "
    "the bonus token is not a draft acceptance)",
)
