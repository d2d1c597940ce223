"""Per-request serving telemetry: journeys, latency stamps, goodput.

Counterpart of ``nos_tpu/serve/telemetry.py``, over the port's own
metrics registry and tracer (``nos_tpu_torch.util``):

- **Request journeys.** Each submitted request registers a journey root
  span (``serve.request``, keyed by ``(serve, engine, request id)``) and
  the engine's stages parent onto it: ``serve.submit`` → ``serve.queue``
  (submit to admit) → ``serve.admit`` (with ``serve.prefill`` and
  ``serve.prefix_restore`` sub-spans) → ``serve.decode`` (admission to
  last token) → ``serve.retire``.
- **Latency stamps.** ``submit_t`` / ``admit_t`` / ``first_token_t`` /
  ``retire_t`` per request. The first-token stamp is taken when the
  token is *emitted to the host*: under deferred admission resolution
  the prefill token only reaches the host at the end-of-chunk pull, so
  TTFT honestly includes that decode chunk.
- **Derived metrics.** At retire the request observes TTFT, TPOT,
  end-to-end latency, queue wait and request tokens/sec into labeled
  histograms (model/adapter/bucket), plus goodput counters: a request is
  *good* when it met the configured ``ttft_target_s`` / ``e2e_target_s``.
- **Clocks.** Stamps come from a pluggable ``ServeClock``. The default
  reads ``time.monotonic``; ``VirtualServeClock`` advances a virtual
  timeline from a deterministic cost model (seconds per decode tick,
  per prefill token), so latencies are a pure function of the workload.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.tracing import NOOP_SPAN, TRACER, Span


class ServeClock:
    """Wall-clock stamps; cost hooks are no-ops (time passes by itself)."""

    def now(self) -> float:
        return time.monotonic()

    def on_prefill(self, tokens: int) -> None:
        pass

    def on_decode(self, ticks: int) -> None:
        pass


class VirtualServeClock(ServeClock):
    """Deterministic virtual timeline driven by a cost model.

    ``now()`` only moves when the engine reports work (``on_prefill`` /
    ``on_decode``) or a load generator advances it to an arrival time, so every
    latency derived from it is a pure function of the workload and the
    engine's scheduling decisions, bit-stable at a fixed seed.

    The defaults (8 ms per batched decode tick, 0.2 ms per prefill
    token) are a *model*, not a measurement of any device: the point is
    determinism, with queue waits, chunked-prefill cost and prefix-cache
    savings in plausible proportions.
    """

    def __init__(
        self,
        tick_cost_s: float = 0.008,
        prefill_token_cost_s: float = 0.0002,
        start: float = 0.0,
    ) -> None:
        self.tick_cost_s = tick_cost_s
        self.prefill_token_cost_s = prefill_token_cost_s
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += max(0.0, dt)

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, t)

    def on_prefill(self, tokens: int) -> None:
        self._now += tokens * self.prefill_token_cost_s

    def on_decode(self, ticks: int) -> None:
        self._now += ticks * self.tick_cost_s


@dataclass
class RequestRecord:
    """One request's journey stamps (None until the stage happens)."""

    id: int
    model: str
    adapter: int
    bucket: int
    prompt_tokens: int
    max_new_tokens: int
    submit_t: float
    trace_id: str = ""
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    retire_t: Optional[float] = None
    tokens: int = 0
    good: Optional[bool] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.retire_t is None:
            return None
        return self.retire_t - self.submit_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Per-token decode latency: last-token minus first-token wall
        time over the tokens after the first. None until retired; 0.0
        for single-token completions (no decode happened)."""
        if self.retire_t is None or self.first_token_t is None:
            return None
        if self.tokens <= 1:
            return 0.0
        return (self.retire_t - self.first_token_t) / (self.tokens - 1)

    @property
    def tokens_per_s(self) -> Optional[float]:
        e2e = self.e2e_s
        if e2e is None:
            return None
        return self.tokens / e2e if e2e > 0 else float(self.tokens)


class ServeTelemetry:
    """Per-engine request tracker: stamps, spans, histograms, goodput.

    One instance per engine (the engine constructs a default); the
    engine calls the hooks at its stage boundaries. Everything is
    bounded: live records are popped at retire and completed records
    land in a capped ring (``completed``, newest kept).
    """

    MAX_COMPLETED = 4096

    def __init__(
        self,
        model: str = "default",
        clock: Optional[ServeClock] = None,
        ttft_target_s: Optional[float] = None,
        e2e_target_s: Optional[float] = None,
        on_complete: Optional[Callable[[RequestRecord], None]] = None,
    ) -> None:
        self.model = model
        self.clock = clock or ServeClock()
        # Per-request goodput targets; None = that dimension never
        # disqualifies. Both None: every completed request is good.
        self.ttft_target_s = ttft_target_s
        self.e2e_target_s = e2e_target_s
        self.on_complete = on_complete
        self._live: Dict[int, RequestRecord] = {}
        self._queue_spans: Dict[int, Span] = {}
        self._decode_spans: Dict[int, Span] = {}
        self.completed: "OrderedDict[int, RequestRecord]" = OrderedDict()

    # ------------------------------------------------------------- keys

    def _journey_key(self, request_id: int) -> Any:
        return ("serve", id(self), request_id)

    def record(self, request_id: int) -> Optional[RequestRecord]:
        return self._live.get(request_id) or self.completed.get(request_id)

    # ------------------------------------------------------------ hooks

    def on_submit(
        self, request, bucket: int, submit_at: Optional[float] = None
    ) -> RequestRecord:
        """Stamp submission and open the journey. ``submit_at`` lets an
        open-loop load generator stamp the request's *arrival* time even when it
        hands the request over later in virtual time."""
        now = self.clock.now() if submit_at is None else submit_at
        rec = RequestRecord(
            id=request.id,
            model=self.model,
            adapter=getattr(request, "adapter", 0),
            bucket=bucket,
            prompt_tokens=len(request.prompt),
            max_new_tokens=request.max_new_tokens,
            submit_t=now,
        )
        self._live[request.id] = rec
        root = TRACER.journey_root(
            self._journey_key(request.id),
            "serve.request",
            request=request.id,
            model=self.model,
            adapter=rec.adapter,
            prompt_tokens=rec.prompt_tokens,
            max_new_tokens=rec.max_new_tokens,
        )
        rec.trace_id = root.trace_id
        submit = TRACER.start_span(
            "serve.submit", parent=root, bucket=bucket
        )
        TRACER.end_span(submit)
        # Queue residency: ends when the admit span opens.
        self._queue_spans[request.id] = TRACER.start_span(
            "serve.queue", parent=root
        )
        return rec

    @contextlib.contextmanager
    def admit_span(self, request):
        """Wraps the engine's admission of one request: ends the queue
        span, stamps ``admit_t``, and makes ``serve.admit`` the current
        span so the prefill/prefix sub-spans (and profiler samples)
        attribute correctly."""
        rec = self._live.get(request.id)
        queue_span = self._queue_spans.pop(request.id, None)
        if queue_span is not None:
            TRACER.end_span(queue_span)
        if rec is not None:
            rec.admit_t = self.clock.now()
        root = TRACER.journey(self._journey_key(request.id))
        with TRACER.span(
            "serve.admit", parent=root or NOOP_SPAN, request=request.id
        ) as span:
            yield span
        # Decode residency: admission done -> last emitted token.
        if rec is not None and root is not None:
            self._decode_spans[request.id] = TRACER.start_span(
                "serve.decode", parent=root, request=request.id
            )

    @contextlib.contextmanager
    def prefill_span(self, request, tokens: int, path: str):
        """One prefill/ingest unit of ``tokens`` prompt tokens. Advances
        the clock's prefill cost on exit (even with tracing disabled —
        the cost model must not depend on the tracer)."""
        try:
            with TRACER.span(
                "serve.prefill", tokens=tokens, path=path
            ) as span:
                yield span
        finally:
            self.clock.on_prefill(tokens)

    @contextlib.contextmanager
    def prefix_restore_span(self, request, reused_tokens: int):
        """A prefix-cache hit restoring ``reused_tokens`` of cached K/V
        (the tokens whose prefill cost is being skipped)."""
        with TRACER.span(
            "serve.prefix_restore", reused_tokens=reused_tokens
        ) as span:
            yield span

    @contextlib.contextmanager
    def decode_span(self, chunks: int, active_slots: int):
        """The engine's batched decode dispatch for one scheduling round
        (all slots at once) — the profiler's 'decode' phase."""
        with TRACER.span(
            "serve.batch_decode", chunks=chunks, active_slots=active_slots
        ) as span:
            yield span

    def on_decode_ticks(self, ticks: int) -> None:
        """Decode progress for cost accounting; called after the round's
        device pull, *before* the host emits its tokens, so deferred
        first tokens carry the chunk's latency."""
        self.clock.on_decode(ticks)

    def on_first_token(self, request) -> None:
        rec = self._live.get(request.id)
        if rec is not None and rec.first_token_t is None:
            rec.first_token_t = self.clock.now()

    def on_retire(self, request, tokens: int) -> None:
        rec = self._live.pop(request.id, None)
        if rec is None:
            return
        now = self.clock.now()
        rec.retire_t = now
        rec.tokens = tokens
        rec.good = self._is_good(rec)
        decode_span = self._decode_spans.pop(request.id, None)
        if decode_span is not None:
            decode_span.set_attributes(tokens=tokens)
            TRACER.end_span(decode_span)
        root = TRACER.journey(self._journey_key(request.id))
        retire = TRACER.start_span(
            "serve.retire", parent=root or NOOP_SPAN, tokens=tokens
        )
        TRACER.end_span(retire)
        TRACER.end_journey(
            self._journey_key(request.id),
            tokens=tokens,
            ttft_s=round(rec.ttft_s or 0.0, 6),
            tpot_s=round(rec.tpot_s or 0.0, 6),
            e2e_s=round(rec.e2e_s or 0.0, 6),
            queue_wait_s=round(rec.queue_wait_s or 0.0, 6),
            good=bool(rec.good),
        )
        self._observe(rec)
        self.completed[rec.id] = rec
        while len(self.completed) > self.MAX_COMPLETED:
            self.completed.popitem(last=False)
        if self.on_complete is not None:
            self.on_complete(rec)

    # ---------------------------------------------------------- derived

    def _is_good(self, rec: RequestRecord) -> bool:
        if self.ttft_target_s is not None and (
            rec.ttft_s is None or rec.ttft_s > self.ttft_target_s
        ):
            return False
        if self.e2e_target_s is not None and (
            rec.e2e_s is None or rec.e2e_s > self.e2e_target_s
        ):
            return False
        return True

    def _observe(self, rec: RequestRecord) -> None:
        labels = dict(
            model=rec.model, adapter=str(rec.adapter), bucket=str(rec.bucket)
        )
        if rec.ttft_s is not None:
            metrics.SERVE_TTFT.labels(**labels).observe(rec.ttft_s)
        if rec.tpot_s is not None and rec.tokens > 1:
            metrics.SERVE_TPOT.labels(**labels).observe(rec.tpot_s)
        if rec.e2e_s is not None:
            metrics.SERVE_E2E.labels(**labels).observe(rec.e2e_s)
        if rec.queue_wait_s is not None:
            metrics.SERVE_QUEUE_WAIT.labels(**labels).observe(rec.queue_wait_s)
        if rec.tokens_per_s is not None:
            metrics.SERVE_REQUEST_TOKENS_PER_S.labels(**labels).observe(
                rec.tokens_per_s
            )
        verdict = "good" if rec.good else "late"
        metrics.SERVE_GOODPUT_REQUESTS.labels(
            model=rec.model, verdict=verdict
        ).inc()
        if rec.good:
            metrics.SERVE_GOODPUT_TOKENS.labels(model=rec.model).inc(
                rec.tokens
            )
