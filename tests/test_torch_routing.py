"""Replica routing (nos_tpu_torch.slo.routing,
nos_tpu_torch.controllers.autoscaler.signals) against nos_tpu.slo.routing and nos_tpu.controllers.autoscaler.signals.

The same arrivals (``slo/driver``'s workload, from a seed, built by each
side's own ``build_arrivals``) and the same ``sync_replicas`` sequence a
model (0 → 2 → 1 → 0 replicas and back, across epochs with cold starts)
go through both routers. Both run on the virtual serving clock, so the
bar is exact equality: each completed request's TTFT, TPOT, end-to-end
and queue wait in completion order, the requests completed an epoch, the
backlog, the replicas' clocks and every ``SignalRegistry`` value after
each epoch. The burn-rate and budget fields, which no router writes,
must stay at their defaults on both sides.
"""
import pytest

from nos_tpu.controllers.autoscaler.signals import SignalRegistry as JRegistry
from nos_tpu.slo import driver as jdriver
from nos_tpu.slo.routing import ReplicaRouter as JRouter
from nos_tpu.slo.routing import SimReplicaEngine as JEngine
from nos_tpu_torch.slo import driver as tdriver
from nos_tpu_torch.slo.routing import ReplicaRouter, SimReplicaEngine
from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry

EPOCH_S = 2.0
COLD_START_S = 1.5
# replicas a model, epoch by epoch
SCHEDULE = {"chat": [0, 2, 2, 1, 0, 0, 2, 1],
            "code": [1, 0, 0, 2, 2, 1, 0, 2]}


def _workload(mod, seed):
    return mod.WorkloadConfig(
        seed=seed, duration_s=EPOCH_S * 8, rate_rps=6.0, diurnal_amplitude=0.5,
        diurnal_period_s=8.0,
        models=(mod.ModelProfile("chat", weight=2.0, prompt_tokens=(8, 64),
                                 max_new_tokens=(4, 40)),
                mod.ModelProfile("code", weight=1.0, prompt_tokens=(32, 128),
                                 max_new_tokens=(8, 24), adapter=1)))


def _record(r):
    return (r.model, r.adapter, r.prompt_tokens, r.max_new_tokens, r.submit_t, r.admit_t,
            r.first_token_t, r.retire_t, r.tokens, r.ttft_s, r.tpot_s, r.e2e_s,
            r.queue_wait_s, r.good)


ROUTED = ("queue_depth", "last_request_t")
UNROUTED = {"burn_fast": 0.0, "burn_slow": 0.0, "error_budget_remaining": 1.0}


def _payload(registry):
    """The registry's payload on the router's two signals; the
    reference's other fields checked untouched."""
    out = {}
    for model, sig in registry.payload().items():
        assert {k: v for k, v in sig.items() if k not in ROUTED} in ({}, UNROUTED)
        out[model] = {k: sig[k] for k in ROUTED}
    return out


def _drive(router_cls, registry, arrivals, done, max_slots):
    router = router_cls(signals=registry, max_slots=max_slots,
                        on_complete={m: (lambda r, m=m: done.append(_record(r)))
                                     for m in SCHEDULE})
    trail = []
    for epoch in range(8):
        start, end = epoch * EPOCH_S, (epoch + 1) * EPOCH_S
        for model, counts in SCHEDULE.items():
            names = [f"{model}-r{(epoch + i) % 3}" for i in range(counts[epoch])]
            created = router.sync_replicas(model, names, ready_t=start + COLD_START_S)
            batch = [a for a in arrivals if a.model == model and start <= a.t < end]
            completed = router.drive(model, batch, epoch_end=end)
            trail.append((epoch, model, created, completed, len(router.backlog[model]),
                          [e.telemetry.clock.now() for e in router.engines(model)]))
        trail.append(_payload(registry))
    return trail


@pytest.mark.parametrize("seed,max_slots", [(0, 4), (1, 8), (2, 2)])
def test_both_routers_give_the_same_records(seed, max_slots):
    jarr = jdriver.build_arrivals(_workload(jdriver, seed))
    tarr = tdriver.build_arrivals(_workload(tdriver, seed))
    assert [(a.t, a.model, a.prompt, a.max_new_tokens, a.adapter) for a in tarr] == \
        [(a.t, a.model, a.prompt, a.max_new_tokens, a.adapter) for a in jarr]
    want_done, got_done = [], []
    want = _drive(JRouter, JRegistry(now_fn=lambda: 0.0), jarr, want_done, max_slots)
    got = _drive(ReplicaRouter, SignalRegistry(), tarr, got_done, max_slots)
    assert got == want
    assert got_done == want_done
    assert len(got_done) > 0.5 * len(tarr)
    # the cold start shows: a request that waited in a backlog has a TTFT
    # past the cold start
    assert max(r[9] for r in got_done) > COLD_START_S


def test_an_engine_alone_matches_the_reference():
    arrivals = tdriver.build_arrivals(_workload(tdriver, 5))[:20]
    jarrivals = jdriver.build_arrivals(_workload(jdriver, 5))[:20]
    engines = [JEngine("chat", max_slots=3, ready_t=0.25), SimReplicaEngine(
        "chat", max_slots=3, ready_t=0.25)]
    for engine, batch in zip(engines, (jarrivals, arrivals)):
        for a in batch:
            engine.submit(a, submit_at=a.t)
        while engine.busy:
            engine.step()
    assert [_record(r) for r in engines[1].telemetry.completed.values()] == \
        [_record(r) for r in engines[0].telemetry.completed.values()]


def test_the_registry_matches_the_reference():
    ref, port = JRegistry(now_fn=lambda: 7.0), SignalRegistry(now_fn=lambda: 7.0)
    for reg in (ref, port):
        reg.note_arrival("a", 3.0, 2)
        reg.note_arrival("a", 1.0, 5)  # an older arrival keeps the newest stamp
        reg.update("b", queue_depth=4)
        reg.update("c", burn_fast=1.5, burn_slow=0.25, error_budget_remaining=0.5)
    assert port.payload() == ref.payload()
    assert port.models() == ref.models() and port.now() == ref.now() == 7.0
    assert port.get("a").queue_depth == ref.get("a").queue_depth == 5
    assert port.get("zzz") == type(port.get("zzz"))()


def test_calibrated_costs_reach_the_replicas():
    router = ReplicaRouter(tick_cost_s=0.05, prefill_token_cost_s=0.001)
    router.sync_replicas("m", ["r0"], ready_t=0.0)
    clock = router.engines("m")[0].telemetry.clock
    assert (clock.tick_cost_s, clock.prefill_token_cost_s) == (0.05, 0.001)
