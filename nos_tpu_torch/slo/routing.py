"""Replica routing: counterpart of ``nos_tpu/slo/routing.py``
(``SimReplicaEngine`` ``:39``, ``ReplicaRouter`` ``:122``).

The open-loop driver (``slo/driver.py``) drives one engine a model. When
a model's replica count changes mid-run, ``ReplicaRouter`` keeps one
cost-model replica (``SimReplicaEngine``) per live replica, spreads each
model's arrivals round-robin over them in name order, and holds a
backlog while a model has no replica: requests keep their arrival
stamps and wait out the cold start in virtual time, which is what makes
the cold start show in TTFT.

``SimReplicaEngine`` is the serving cost model alone, not
``serve/engine.py``: the same ``ServeTelemetry`` hooks and the same
``VirtualServeClock`` arithmetic (a prefill cost a token, one batched
tick a decode round), no device, so a run covers many replica-epochs in
milliseconds with the latency bookkeeping a real engine would keep. The
router takes the clock's two costs (by default the reference's 8 ms
tick and 0.2 ms a prefill token), so they can come from a clock
calibrated on the card (``slo/bench_serve.py --card``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from nos_tpu_torch.serve.telemetry import ServeTelemetry, VirtualServeClock
from nos_tpu_torch.slo.driver import Arrival
from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry

TICK_COST_S = 0.008
PREFILL_TOKEN_COST_S = 0.0002


@dataclass
class _SimRequest:
    """What ServeTelemetry reads off a request."""

    id: int
    prompt: List[int]
    max_new_tokens: int
    adapter: int = 0


class SimReplicaEngine:
    """One replica's continuous-batching cost model, shaped like an
    engine for the driver loop (``submit`` / ``busy`` / ``step`` /
    ``telemetry``): admission fills ``max_slots`` in submit order, each
    ``step`` is one batched decode tick in which every active slot emits
    a token, and a request retires at its token budget."""

    def __init__(self, model: str, max_slots: int = 8, ready_t: float = 0.0,
                 tick_cost_s: float = TICK_COST_S,
                 prefill_token_cost_s: float = PREFILL_TOKEN_COST_S,
                 on_complete=None) -> None:
        self.model = model
        self.max_slots = max_slots
        self.telemetry = ServeTelemetry(
            model=model,
            clock=VirtualServeClock(tick_cost_s=tick_cost_s,
                                    prefill_token_cost_s=prefill_token_cost_s, start=ready_t),
            on_complete=on_complete)
        self._next_id = 0
        self._queue: List[_SimRequest] = []
        # active slots in admission order: [request, tokens emitted]
        self._active: List[List] = []

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._active)

    def submit(self, arrival: Arrival, submit_at: float) -> None:
        req = _SimRequest(id=self._next_id, prompt=list(arrival.prompt),
                          max_new_tokens=max(1, arrival.max_new_tokens),
                          adapter=arrival.adapter)
        self._next_id += 1
        self.telemetry.on_submit(req, bucket=0, submit_at=submit_at)
        self._queue.append(req)

    def step(self) -> None:
        while self._queue and len(self._active) < self.max_slots:
            req = self._queue.pop(0)
            with self.telemetry.admit_span(req):
                with self.telemetry.prefill_span(req, len(req.prompt), path="sim"):
                    pass
            self._active.append([req, 0])
        if not self._active:
            return
        with self.telemetry.decode_span(chunks=1, active_slots=len(self._active)):
            self.telemetry.on_decode_ticks(1)
        retired = []
        for slot in self._active:
            req, emitted = slot
            if emitted == 0:
                self.telemetry.on_first_token(req)
            slot[1] = emitted + 1
            if slot[1] >= req.max_new_tokens:
                retired.append(slot)
        for slot in retired:
            self._active.remove(slot)
            self.telemetry.on_retire(slot[0], slot[1])


class ReplicaRouter:
    """Spreads each model's arrivals over its live replicas.

    A caller runs ``sync_replicas`` after each control epoch with the
    replica names that exist, then ``drive`` with the epoch's arrivals.
    With no replica, arrivals gather in the model's backlog and show as
    queue depth in the signal registry; the next sync's new replicas
    inherit the backlog with its original arrival stamps."""

    def __init__(self, signals: Optional[SignalRegistry] = None, max_slots: int = 8,
                 on_complete: Optional[Dict[str, object]] = None,
                 tick_cost_s: float = TICK_COST_S,
                 prefill_token_cost_s: float = PREFILL_TOKEN_COST_S) -> None:
        self.signals = signals
        self.max_slots = max_slots
        self.on_complete = on_complete or {}
        self.tick_cost_s = tick_cost_s
        self.prefill_token_cost_s = prefill_token_cost_s
        # model -> replica name -> engine (routing walks the names sorted)
        self.replicas: Dict[str, Dict[str, SimReplicaEngine]] = {}
        self.backlog: Dict[str, List[Arrival]] = {}
        self._rr: Dict[str, int] = {}

    def sync_replicas(self, model: str, replica_names: List[str], ready_t: float) -> List[str]:
        """Make the model's engines the named ones; a new replica comes up
        at ``ready_t`` (the epoch's end plus the cold start). Returns the
        names created."""
        engines = self.replicas.setdefault(model, {})
        wanted = set(replica_names)
        for name in [n for n in engines if n not in wanted]:
            del engines[name]
        created = []
        for name in sorted(wanted - set(engines)):
            engines[name] = SimReplicaEngine(
                model, max_slots=self.max_slots, ready_t=ready_t,
                tick_cost_s=self.tick_cost_s, prefill_token_cost_s=self.prefill_token_cost_s,
                on_complete=self.on_complete.get(model))
            created.append(name)
        return created

    def engines(self, model: str) -> List[SimReplicaEngine]:
        return [e for _, e in sorted(self.replicas.get(model, {}).items())]

    def drive(self, model: str, arrivals: List[Arrival], epoch_end: float) -> int:
        """Queue the epoch's arrivals behind the backlog, run the model's
        replicas to completion in virtual time and set every replica's
        clock to ``epoch_end``. Returns the requests completed."""
        backlog = self.backlog.setdefault(model, [])
        backlog.extend(arrivals)
        last_t = max((a.t for a in backlog), default=None)
        completed = 0
        if self.engines(model):
            names = sorted(self.replicas[model])
            rr = self._rr.get(model, 0)
            per_engine: Dict[str, List[Arrival]] = {n: [] for n in names}
            for a in backlog:
                per_engine[names[rr % len(names)]].append(a)
                rr += 1
            self._rr[model] = rr
            backlog.clear()
            for name in names:
                completed += self._drive_engine(self.replicas[model][name],
                                                per_engine[name], epoch_end)
        if self.signals is not None:
            if last_t is not None:
                self.signals.note_arrival(model, last_t, len(backlog))
            else:
                self.signals.update(model, queue_depth=len(backlog))
        return completed

    @staticmethod
    def _drive_engine(engine: SimReplicaEngine, arrivals: List[Arrival],
                      epoch_end: float) -> int:
        clock = engine.telemetry.clock
        before = len(engine.telemetry.completed)
        i = 0
        while i < len(arrivals) or engine.busy:
            while i < len(arrivals) and arrivals[i].t <= clock.now():
                engine.submit(arrivals[i], submit_at=arrivals[i].t)
                i += 1
            if engine.busy:
                engine.step()
            elif i < len(arrivals):
                clock.advance_to(arrivals[i].t)
        clock.advance_to(epoch_end)
        return len(engine.telemetry.completed) - before
