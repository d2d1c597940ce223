"""The health timeline (nos_tpu_torch.timeline) against nos_tpu.timeline.

- Detectors: seeded random windows (numpy seeds) of flat, rising,
  noisy, stepped and resetting shapes go through both packages'
  ``median``, ``theil_sen_slope``, ``detect_stall``, ``detect_leak``,
  ``detect_regression`` and ``run_detector`` (JSON-shaped windows
  included): every verdict and slope is exactly equal.
- ``TimelineStore``: fresh stores on both sides (vitals off, an injected
  clock, private ``SizeRegistry`` and ``WedgeWatchdog``), fed the same
  seeded emissions through ``metrics_fn`` and through a registry cursor
  (fresh ``MetricsRegistry`` instances), with sizes, periodic and armed
  loops, removals and evictions: ``iter_jsonl``, ``rollups``,
  ``sparkline``, ``findings`` (their windows and params) and the paged
  ``debug_payload`` are exactly equal at every step.
- The port alone: hysteresis (a finding fires once, clears after
  ``clear_samples`` quiet checks, fires again), eviction into the base
  frame (every retained sample rebuilds), the recent-points cache
  dropping a vanished series, a ``HealthDegraded`` event through an
  attached recorder, and ``/debug/timeline`` read over HTTP while
  another thread samples.

No test writes the reference's singletons; the port's are left as found.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

from nos_tpu.timeline import detectors as jdet
from nos_tpu.timeline import sizes as jsizes
from nos_tpu.timeline import store as jstore
from nos_tpu.timeline import watchdog as jwatch
from nos_tpu.util import metrics as jmetrics
from nos_tpu_torch.timeline import detectors as tdet
from nos_tpu_torch.timeline import sizes as tsizes
from nos_tpu_torch.timeline import store as tstore
from nos_tpu_torch.timeline import watchdog as twatch
from nos_tpu_torch.util import metrics as tmetrics

SEEDS = range(12)


def _window(seed):
    """A seeded window of one of five shapes."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    t = np.cumsum(rng.uniform(0.5, 5.0, n)) + 1000.0
    shape = seed % 5
    if shape == 0:  # a counter that stops
        v = np.concatenate([np.cumsum(rng.integers(0, 4, n // 2)), np.zeros(n - n // 2)])
        v[n // 2:] = v[n // 2 - 1] if n // 2 else 0
    elif shape == 1:  # steady growth
        v = np.cumsum(rng.uniform(0, 60, n))
    elif shape == 2:  # noise
        v = rng.normal(100.0, 30.0, n)
    elif shape == 3:  # a step up
        v = np.where(np.arange(n) < n // 2, 10.0, 10.0 * rng.uniform(1.0, 3.0))
    else:  # growth with a reset
        v = np.cumsum(rng.uniform(0, 80, n))
        v[n // 3:] -= v[n // 3]
    # duplicate timestamps exercise the zero-dt pairs
    if n > 3:
        t[2] = t[1]
    return [(float(a), float(b)) for a, b in zip(t, v)]


@pytest.mark.parametrize("seed", SEEDS)
def test_detectors_give_the_references_verdicts(seed):
    points = _window(seed)
    assert tdet.median([v for _, v in points]) == jdet.median([v for _, v in points])
    assert tdet.theil_sen_slope(points) == jdet.theil_sen_slope(points)
    for flat in (1, 3, 5):
        assert tdet.detect_stall(points, flat_windows=flat) == \
            jdet.detect_stall(points, flat_windows=flat)
    for budget, frac in ((0.0, 0.9), (50.0, 0.5), (256.0, 0.9)):
        kw = dict(budget=budget, min_points=4, monotonic_fraction=frac)
        assert tdet.detect_leak(points, **kw) == jdet.detect_leak(points, **kw)
    for base, recent, ratio, floor in ((4, 4, 1.5, 0.0), (3, 5, 1.1, 2.0), (8, 8, 1.5, 0.0)):
        kw = dict(baseline_points=base, recent_points=recent, ratio=ratio, abs_floor=floor)
        assert tdet.detect_regression(points, **kw) == jdet.detect_regression(points, **kw)
    as_json = json.loads(json.dumps([[t, v] for t, v in points]))
    for detector, params in ((tdet.STALL, {"flat_windows": 2}),
                             (tdet.LEAK, {"budget": 10.0, "min_points": 3}),
                             (tdet.REGRESSION, {"baseline_points": 2, "recent_points": 2})):
        assert tdet.run_detector(detector, as_json, params) == \
            jdet.run_detector(detector, as_json, params)
        assert tdet.run_detector(detector, points, params, normalized=True) == \
            jdet.run_detector(detector, points, params, normalized=True)


def test_detectors_fire_on_their_shapes():
    stalled = [(float(i), float(min(i, 4))) for i in range(12)]
    assert tdet.detect_stall(stalled)["flat_since"] == 6.0
    assert tdet.detect_stall([(float(i), 0.0) for i in range(8)]) is None  # never ran
    leak = [(float(i), 40.0 * i) for i in range(10)]
    assert tdet.detect_leak(leak)["slope_per_second"] == 40.0
    step = [(float(i), 1.0 if i < 8 else 3.0) for i in range(16)]
    assert tdet.detect_regression(step)["ratio"] == 3.0


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _policy(mod, **kw):
    return mod.DetectorPolicy(stall_flat_windows=3, stall_series=("loop.armed",),
                              leak_budget=20.0, leak_budgets={"size.ring": 1e9},
                              leak_window=12, leak_min_points=4,
                              regression_series=("lat_p95",), regression_baseline_points=3,
                              regression_recent_points=3, clear_samples=2, **kw)


class Side:
    """One package's store, sizes, watchdog and emission state."""

    def __init__(self, store_mod, sizes_mod, watch_mod, metrics_mod, cursor, capacity):
        self.clock = Clock()
        self.values = {}
        self.sizes = sizes_mod.SizeRegistry()
        self.watchdog = watch_mod.WedgeWatchdog()
        self.counts = {}
        self.registry = metrics_mod.MetricsRegistry() if cursor else None
        kw = ({"registry": self.registry} if cursor
              else {"metrics_fn": lambda: dict(self.values)})
        self.store = store_mod.TimelineStore(
            capacity=capacity, clock=self.clock, policy=_policy(store_mod), vitals=False,
            sizes=self.sizes, watchdog=self.watchdog, recent_evict_frames=2, **kw)

    def size(self, name, n):
        self.counts[name] = n
        self.sizes.register(name, lambda name=name: self.counts[name])


def _drive(cursor, capacity, seed, steps=40):
    """Both sides through one seeded emission stream; yields them after
    every tick with that tick's new findings."""
    ref = Side(jstore, jsizes, jwatch, jmetrics, cursor, capacity)
    port = Side(tstore, tsizes, twatch, tmetrics, cursor, capacity)
    rng = np.random.default_rng(seed)
    for side in (ref, port):
        side.watchdog.register("sampler", periodic=True)
        side.watchdog.register("armed")
        side.size("ring", 0)
    for step in range(steps):
        ops = [int(x) for x in rng.integers(0, 8, 4)]
        amount = float(rng.integers(1, 30))
        for side in (ref, port):
            side.clock.now += 5.0
            for op in ops:
                if op == 0:
                    side.watchdog.beat("sampler")
                elif op == 1 and step < 20:
                    side.watchdog.beat("armed")
                elif op == 2:
                    side.size("ring", side.counts["ring"] + int(amount))
                elif op == 3:
                    side.size("grow", side.counts.get("grow", 0) + int(amount))
                elif op == 4:
                    side.size("flap", int(amount)) if step % 3 else \
                        side.sizes.unregister("flap")
                if cursor:
                    reg = side.registry
                    if op == 5:
                        reg.counter("nos_tpu_c_total", "c").labels(k=str(step % 3)).inc(amount)
                    elif op == 6:
                        reg.gauge("nos_tpu_g", "g").labels(node=f"n{step % 4}").set(amount)
                    elif op == 7:
                        reg.histogram("lat", "l").observe(amount / 10.0)
                        if step % 7 == 0:
                            reg.gauge("nos_tpu_g", "g").remove(node="n1")
                else:
                    if op == 5:
                        side.values["c"] = side.values.get("c", 0.0) + amount
                    elif op == 6:
                        side.values["lat_p95"] = amount * (1 if step < 25 else 4)
                    elif op == 7:
                        side.values.pop("c", None)
        found = [side.store.tick() for side in (ref, port)]
        yield ref, port, found


def _strip_stacks(findings):
    return [{k: v for k, v in f.items() if k != "stacks"} for f in findings]


@pytest.mark.parametrize("cursor", [False, True], ids=["metrics_fn", "cursor"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_store_equals_the_references_on_the_same_emissions(cursor, seed):
    for ref, port, (ref_new, port_new) in _drive(cursor, capacity=16, seed=seed):
        assert _strip_stacks(port_new) == _strip_stacks(ref_new)
        assert list(port.store.iter_jsonl()) == list(ref.store.iter_jsonl())
        assert port.store.names() == ref.store.names()
        assert port.store.rollups() == ref.store.rollups()
        assert port.store.rollups(window_seconds=30.0) == ref.store.rollups(window_seconds=30.0)
        for name in ref.store.names():
            assert port.store.sparkline(name, 8) == ref.store.sparkline(name, 8)
    assert port.store.to_jsonl() == ref.store.to_jsonl()
    assert _strip_stacks(port.store.findings()) == _strip_stacks(ref.store.findings())
    assert port.store.findings_payload() == ref.store.findings_payload()
    names = ref.store.names()
    for limit, page_cursor in ((0, ""), (2, ""), (3, names[1])):
        assert port.store.debug_payload(20.0, 8, limit, page_cursor) == \
            ref.store.debug_payload(20.0, 8, limit, page_cursor)
    for side in (ref, port):
        side.store.close()


def test_the_streams_findings_cover_every_detector():
    """The parity stream is not vacuous: it finds stalls, leaks and a
    regression."""
    for _, port, _ in _drive(False, capacity=16, seed=0, steps=40):
        pass
    detectors = {f["detector"] for f in port.store.findings()}
    assert detectors == {tdet.STALL, tdet.LEAK, tdet.REGRESSION}, detectors


def _store(values, clock, **kw):
    return tstore.TimelineStore(clock=clock, vitals=False, metrics_fn=lambda: dict(values),
                                sizes=tsizes.SizeRegistry(), watchdog=twatch.WedgeWatchdog(),
                                **kw)


def test_hysteresis_fires_once_clears_and_fires_again():
    clock, values = Clock(), {"beats": 1.0}
    policy = tstore.DetectorPolicy(stall_flat_windows=2, stall_series=("beats",),
                                   clear_samples=2)
    store = _store(values, clock, policy=policy)
    fired = []
    for step in range(14):
        clock.now += 1.0
        # flat for steps 0-5, moving 6-8, flat again from 9
        if 6 <= step <= 8:
            values["beats"] += 1.0
        fired.append(len(store.tick()))
    assert fired == [0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0], fired
    assert [f["series"] for f in store.findings()] == ["beats", "beats"]
    assert store.debug_payload()["active_findings"] == ["stall:beats"]


def test_eviction_folds_into_the_base_and_every_sample_rebuilds():
    clock, values = Clock(), {}
    store = _store(values, clock, capacity=5)
    history = []
    for step in range(12):
        clock.now += 1.0
        values[f"k{step % 4}"] = float(step)
        if step == 7:
            values.pop("k1")
        store.sample_once()
        history.append((clock.now, dict(values)))
    assert len(store) == 5 and store.samples == 12
    frames = list(store.iter_jsonl())
    assert frames[0]["kind"] == "timeline.base" and frames[0]["samples"] == 12
    # the base plus each retained delta rebuilds every retained sample
    state = {k: v for k, v in frames[0]["base"].items()}
    for frame, (t, want) in zip(frames[1:], history[-5:]):
        for k, v in frame["d"].items():
            if v is None:
                state.pop(k, None)
            else:
                state[k] = v
        assert frame["t"] == t
        got = {k: v for k, v in state.items() if not k.startswith("size.")}
        assert got == want
    # gone at the retained steps 7 and 8, set again at 9 and carried
    assert [v for _, v in store.series("k1")] == [9.0, 9.0, 9.0]
    assert [v for _, v in store.series("k0")] == [4.0, 8.0, 8.0, 8.0, 8.0]  # 4.0 from the base


def test_the_recent_cache_drops_a_vanished_series():
    clock, values = Clock(), {}
    sizes = tsizes.SizeRegistry()
    store = tstore.TimelineStore(clock=clock, vitals=False, metrics_fn=lambda: dict(values),
                                 sizes=sizes, watchdog=twatch.WedgeWatchdog(),
                                 recent_evict_frames=3)
    sizes.register("gone", lambda: 3)
    store.sample_once()
    assert "size.gone" in store._recent
    sizes.unregister("gone")
    for _ in range(2):
        store.sample_once()
        assert "size.gone" in store._recent  # the grace window
    store.sample_once()
    assert "size.gone" not in store._recent
    assert sizes.sizes()["timeline.recent_series"] == float(len(store._recent))


def test_a_finding_records_a_health_degraded_event():
    from nos_tpu_torch.kube.events import EventRecorder
    from nos_tpu_torch.kube.objects import ConfigMap
    from nos_tpu_torch.kube.store import NodeStore

    clock, values = Clock(), {"beats": 0.0}
    kube = NodeStore()
    store = _store(values, clock, policy=tstore.DetectorPolicy(
        stall_flat_windows=2, stall_series=("beats",)))
    store.attach(recorder=EventRecorder(kube, component="nos-health-timeline", clock=clock),
                 event_obj=ConfigMap("nos-health-timeline", "default"))
    for step in range(5):
        clock.now += 1.0
        values["beats"] = float(min(step, 1) + 1)
        store.tick()
    events = kube.list("Event", namespace="default")
    assert [(e.reason, e.type, e.involved_name) for e in events] == [
        ("HealthDegraded", "Warning", "nos-health-timeline")]
    assert events[0].message.startswith('stall finding on beats: {"detector": "stall"')


def test_the_sampler_thread_registers_as_a_periodic_loop():
    clock, values = Clock(), {"x": 1.0}
    watchdog = twatch.WedgeWatchdog()
    store = tstore.TimelineStore(clock=clock, vitals=False, metrics_fn=lambda: dict(values),
                                 sizes=tsizes.SizeRegistry(), watchdog=watchdog,
                                 interval_seconds=3600.0)
    store.start()
    try:
        assert watchdog.periodic_loops() == ["timeline-sampler"]
        assert watchdog.thread_name("timeline-sampler") == "timeline-sampler"
    finally:
        store.stop()
    assert watchdog.periodic_loops() == []


def test_vitals_sample_the_process():
    store = tstore.TimelineStore(vitals=True, metrics_fn=dict, sizes=tsizes.SizeRegistry(),
                                 watchdog=twatch.WedgeWatchdog())
    values = store.sample_once(now=1.0)
    assert values["process.rss_bytes"] > 0 and values["process.threads"] >= 1


def test_debug_timeline_is_served_while_another_thread_samples():
    from nos_tpu_torch.util.health import HealthServer

    clock, values = Clock(), {}
    store = _store(values, clock, capacity=64)
    registry = tmetrics.MetricsRegistry()
    stop, errors = threading.Event(), []

    def sampler():
        i = 0
        try:
            while not stop.is_set():
                clock.now += 1.0
                values[f"s{i % 50}"] = float(i)
                registry.counter("nos_tpu_churn_total", "c").labels(k=str(i % 9)).inc()
                store.sample_once()
                i += 1
        except Exception as exc:  # the failure this test looks for
            errors.append(repr(exc))

    server = HealthServer(port=0, metrics_token="tok", timeline_fn=store.debug_payload,
                          timeline_stream_fn=store.iter_jsonl)
    port = server.start()
    thread = threading.Thread(target=sampler, daemon=True)
    thread.start()
    try:
        for round_no in range(30):
            path = "/debug/timeline" + ("?window=5&limit=7" if round_no % 2 else
                                        "?format=jsonl")
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         headers={"Authorization": "Bearer tok"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = resp.read().decode()
            if round_no % 2:
                doc = json.loads(body)
                assert doc["page"]["limit"] == 7 and len(doc["rollups"]) <= 7
            else:
                lines = [json.loads(x) for x in body.splitlines()]
                assert lines[0]["kind"] == "timeline.base"
    finally:
        stop.set()
        thread.join(5)
        server.stop()
    assert not errors, errors
