"""The health timeline's store: counterpart of ``nos_tpu/timeline/store.py``.

Every ``interval_seconds`` the store samples the metrics registry
(counters, gauges, a histogram's count, sum and percentiles: the
``/debug/vars`` shape), the process's vitals (RSS from
``/proc/self/statm``, the live thread count), the ``SizeRegistry``
(``size.*``) and the ``WedgeWatchdog``'s counters (``loop.*``) into a
bounded ring. Each entry holds only the series that changed since the
one before, and an evicted entry folds into a base frame, so every
retained sample can be rebuilt. By default the registry is read through
a ``SnapshotCursor`` (``MetricsRegistry.cursor``), so a sample costs the
series touched since the last one, not all of them; ``metrics_fn`` takes
a full snapshot function instead.

``tick()`` samples, then ``check()`` runs the detectors over the last
points of every watched series (the periodic loops' ``loop.*``, every
``size.*`` and the policy's own series), kept apart from the ring so a
check never replays it. A finding fires once (hysteresis: it clears
after ``clear_samples`` clean checks) and is counted in
``nos_tpu_timeline_findings_total``; an ``attach``ed ``EventRecorder``
records a ``HealthDegraded`` event about ``event_obj``, and an attached
flight recorder (``flight``) a ``timeline.finding`` record carrying the
detector's window and parameters beside its verdict, which replay re-runs
(the reference's ``:228-234``, ``:547-560``).

The ring reads as ``series`` / ``rollups`` / ``sparkline``, as JSONL
(``iter_jsonl`` / ``to_jsonl`` / ``export``) and as ``/debug/timeline``'s
``debug_payload``; ``start()`` runs ``tick()`` on a daemon thread,
itself a periodic loop of the watchdog.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from nos_tpu_torch.timeline import detectors
from nos_tpu_torch.timeline.sizes import SIZES, SizeRegistry
from nos_tpu_torch.timeline.watchdog import WATCHDOG, WedgeWatchdog
from nos_tpu_torch.util import metrics

# The profiler, the api constants and the obsplane helpers are imported
# where they are used: util/tracing.py registers its ring with
# timeline.sizes at its bottom, which runs this package's import.

Point = Tuple[float, float]

_REMOVED = None  # a delta's mark: the series vanished in this sample


class _RssReader:
    """``/proc/self/statm`` kept open across samples."""

    def __init__(self) -> None:
        self._fh = None
        self._pagesize: Optional[int] = None

    def read(self) -> Optional[float]:
        try:
            if self._pagesize is None:
                import resource

                self._pagesize = resource.getpagesize()
            if self._fh is None:
                self._fh = open("/proc/self/statm", "rb")
            self._fh.seek(0)
            return float(int(self._fh.read().split()[1]) * self._pagesize)
        except Exception:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
            return None


_RSS = _RssReader()


class DetectorPolicy:
    """The detectors' budgets. The defaults keep a healthy process clean
    (rings filling, caches churning, counters ticking); a harness
    tightens them, or arms an event-driven loop's series
    (``stall_series``)."""

    def __init__(self, *, stall_flat_windows: int = detectors.DEFAULT_STALL_WINDOWS,
                 stall_series: Tuple[str, ...] = (),
                 leak_budget: float = detectors.DEFAULT_LEAK_BUDGET,
                 leak_budgets: Optional[Dict[str, float]] = None,
                 leak_series: Tuple[str, ...] = (), leak_window: int = 64,
                 leak_min_points: int = detectors.DEFAULT_LEAK_MIN_POINTS,
                 leak_monotonic_fraction: float = detectors.DEFAULT_LEAK_MONOTONIC_FRACTION,
                 regression_series: Tuple[str, ...] = (),
                 regression_ratio: float = detectors.DEFAULT_REGRESSION_RATIO,
                 regression_baseline_points: int = detectors.DEFAULT_REGRESSION_MIN_POINTS,
                 regression_recent_points: int = detectors.DEFAULT_REGRESSION_MIN_POINTS,
                 regression_abs_floor: float = 0.0, clear_samples: int = 3) -> None:
        self.stall_flat_windows = stall_flat_windows
        self.stall_series = tuple(stall_series)
        self.leak_budget = leak_budget
        self.leak_budgets = dict(leak_budgets or {})
        self.leak_series = tuple(leak_series)
        self.leak_window = leak_window
        self.leak_min_points = leak_min_points
        self.leak_monotonic_fraction = leak_monotonic_fraction
        self.regression_series = tuple(regression_series)
        self.regression_ratio = regression_ratio
        self.regression_baseline_points = regression_baseline_points
        self.regression_recent_points = regression_recent_points
        self.regression_abs_floor = regression_abs_floor
        self.clear_samples = clear_samples

    def stall_params(self) -> dict:
        return {"flat_windows": self.stall_flat_windows}

    def leak_params(self, series: str) -> dict:
        return {"budget": self.leak_budgets.get(series, self.leak_budget),
                "min_points": self.leak_min_points,
                "monotonic_fraction": self.leak_monotonic_fraction}

    def regression_params(self) -> dict:
        return {"baseline_points": self.regression_baseline_points,
                "recent_points": self.regression_recent_points,
                "ratio": self.regression_ratio, "abs_floor": self.regression_abs_floor}


class TimelineStore:
    MAX_FINDINGS = 256

    def __init__(self, *, capacity: int = 4096, interval_seconds: float = 5.0,
                 clock: Callable[[], float] = time.time,
                 policy: Optional[DetectorPolicy] = None, vitals: bool = True,
                 metrics_fn: Optional[Callable[[], Dict[str, float]]] = None,
                 sizes: Optional[SizeRegistry] = None,
                 watchdog: Optional[WedgeWatchdog] = None,
                 registry: Optional[metrics.MetricsRegistry] = None,
                 recent_evict_frames: int = 8) -> None:
        self.capacity = capacity
        self.interval_seconds = interval_seconds
        self.clock = clock
        self.policy = policy or DetectorPolicy()
        self.vitals = vitals
        if metrics_fn is None:
            self._registry = registry if registry is not None else metrics.REGISTRY
            self._cursor = self._registry.cursor()
            # a closed store samples full snapshots
            self.metrics_fn: Optional[Callable[[], Dict[str, float]]] = self._registry.snapshot
        else:
            self._registry = None
            self._cursor = None
            self.metrics_fn = metrics_fn
        self.sizes = SIZES if sizes is None else sizes
        self.watchdog = WATCHDOG if watchdog is None else watchdog
        self._lock = threading.Lock()
        self._entries: List[dict] = []
        self._base: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        # the last points of every watched series, as long as the longest
        # detector window; a series absent ``recent_evict_frames`` samples
        # in a row is dropped (churn must not grow it)
        self._recent_len = max(
            self.policy.leak_window, self.policy.stall_flat_windows + 1,
            self.policy.regression_baseline_points + self.policy.regression_recent_points)
        self._recent: Dict[str, Deque[Point]] = {}
        self.recent_evict_frames = max(1, recent_evict_frames)
        self._recent_absent: Dict[str, int] = {}
        # the size./loop./process. keys of the last sample (the cursor
        # covers only the registry)
        self._aux_keys: set = set()
        self._samples = 0
        self.sizes.register("timeline.recent_series", lambda: len(self._recent))
        self._findings: List[dict] = []
        self._active: Dict[Tuple[str, str], dict] = {}
        self.recorder = None
        self._event_obj = None
        self._flight = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()

    def attach(self, *, flight=None, recorder=None, event_obj=None) -> None:
        """Findings become ``timeline.finding`` records of ``flight`` (a
        ``FlightRecorder``) and ``HealthDegraded`` events about
        ``event_obj`` through ``recorder`` (an ``EventRecorder``)."""
        self._flight = flight
        self.recorder = recorder
        self._event_obj = event_obj

    # ----------------------------------------------------------- sampling

    def _collect_aux(self) -> Dict[str, float]:
        values: Dict[str, float] = {}
        for name, size in self.sizes.sizes().items():
            values[f"size.{name}"] = size
        for name, count in self.watchdog.counters().items():
            values[f"loop.{name}"] = count
        if self.vitals:
            rss = _RSS.read()
            if rss is not None:
                values["process.rss_bytes"] = rss
            values["process.threads"] = float(threading.active_count())
        return values

    def collect(self) -> Dict[str, float]:
        """One full sample of every collector (the ring untouched)."""
        values: Dict[str, float] = {}
        if self.metrics_fn is not None:
            values.update(self.metrics_fn())
        values.update(self._collect_aux())
        return values

    def _watched_names(self) -> set:
        watched = {f"loop.{name}" for name in self.watchdog.periodic_loops()}
        watched.update(self.policy.stall_series)
        watched.update(self.policy.leak_series)
        watched.update(self.policy.regression_series)
        return watched

    def sample_once(self, now: Optional[float] = None) -> Dict[str, float]:
        """Append one delta-encoded sample; every series' value."""
        started = time.perf_counter()
        if now is None:
            now = self.clock()
        if self._cursor is None:
            values = self.collect()
        else:
            changed, removed = self._cursor.collect()
            aux = self._collect_aux()
        watched = self._watched_names()
        with self._lock:
            if self._cursor is None:
                delta: Dict[str, Optional[float]] = {
                    k: v for k, v in values.items() if self._last.get(k) != v}
                for gone in self._last:
                    if gone not in values:
                        delta[gone] = _REMOVED
            else:
                values = dict(self._last)
                delta = {}
                for key in removed:
                    if key in values:
                        del values[key]
                        delta[key] = _REMOVED
                for key, value in changed.items():
                    if values.get(key) != value:
                        values[key] = value
                        delta[key] = value
                for key in self._aux_keys:
                    if key not in aux and key in values:
                        del values[key]
                        delta[key] = _REMOVED
                for key, value in aux.items():
                    if values.get(key) != value:
                        values[key] = value
                        delta[key] = value
                self._aux_keys = set(aux)
            for name, value in values.items():
                if name not in watched and not name.startswith("size."):
                    continue
                window = self._recent.get(name)
                if window is None:
                    window = self._recent[name] = collections.deque(maxlen=self._recent_len)
                # floats at insertion: a window is a detector's input as is
                window.append((float(now), float(value)))
                self._recent_absent.pop(name, None)
            for name in list(self._recent):
                if name not in values:
                    absent = self._recent_absent.get(name, 0) + 1
                    if absent >= self.recent_evict_frames:
                        self._recent.pop(name, None)
                        self._recent_absent.pop(name, None)
                    else:
                        self._recent_absent[name] = absent
            self._entries.append({"t": now, "d": delta})
            while len(self._entries) > self.capacity:
                evicted = self._entries.pop(0)
                for key, value in evicted["d"].items():
                    if value is _REMOVED:
                        self._base.pop(key, None)
                    else:
                        self._base[key] = value
            self._last = values
            self._samples += 1
        metrics.TIMELINE_SAMPLES.inc()
        metrics.TIMELINE_SERIES.set(len(values))
        metrics.TIMELINE_SAMPLE_DURATION.observe(time.perf_counter() - started)
        return values

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Sample, then check; the new findings."""
        if now is None:
            now = self.clock()
        self.sample_once(now)
        return self.check(now)

    # --------------------------------------------------------- ring reads

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._last)

    def series(self, name: str, window_seconds: Optional[float] = None) -> List[Point]:
        """One series' points, a value carried through the samples where
        it did not change."""
        with self._lock:
            entries = list(self._entries)
            current = self._base.get(name)
        points: List[Point] = []
        for entry in entries:
            if name in entry["d"]:
                current = entry["d"][name]
            if current is not None:
                points.append((entry["t"], current))
        if window_seconds is not None and points:
            horizon = points[-1][0] - window_seconds
            points = [p for p in points if p[0] >= horizon]
        return points

    def iter_jsonl(self):
        """The ring frame by frame: a header with the folded base, then
        one delta a retained sample (snapshotted once under the lock)."""
        with self._lock:
            header = {"kind": "timeline.base", "base": dict(sorted(self._base.items())),
                      "samples": self._samples}
            entries = list(self._entries)
        yield header
        for entry in entries:
            yield {"t": entry["t"], "d": dict(sorted(entry["d"].items()))}

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(frame, sort_keys=True)
                         for frame in self.iter_jsonl()) + "\n"

    def export(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_jsonl())

    # ---------------------------------------------------------- detectors

    def _stall_targets(self) -> List[str]:
        targets = [f"loop.{name}" for name in self.watchdog.periodic_loops()]
        targets.extend(self.policy.stall_series)
        return targets

    def _leak_targets(self) -> List[str]:
        with self._lock:
            sized = [n for n in sorted(self._last) if n.startswith("size.")]
        sized.extend(self.policy.leak_series)
        return sized

    def _detector_windows(self):
        """(detector, series, window, params) of every detector pass, the
        windows from the recent-points cache."""
        stall_targets = self._stall_targets()
        leak_targets = self._leak_targets()
        with self._lock:
            history = {name: list(self._recent.get(name, ()))
                       for name in set(stall_targets) | set(leak_targets)
                       | set(self.policy.regression_series)}
        stall_params = self.policy.stall_params()
        for name in stall_targets:
            yield (detectors.STALL, name,
                   history[name][-(self.policy.stall_flat_windows + 1):], stall_params)
        for name in leak_targets:
            yield (detectors.LEAK, name, history[name][-self.policy.leak_window:],
                   self.policy.leak_params(name))
        regression_params = self.policy.regression_params()
        for name in self.policy.regression_series:
            yield detectors.REGRESSION, name, history[name], regression_params

    def check(self, now: Optional[float] = None) -> List[dict]:
        """The new findings over the current windows (an active finding
        refreshes silently until it clears)."""
        if now is None:
            now = self.clock()
        new_findings: List[dict] = []
        seen: Dict[Tuple[str, str], bool] = {}
        for detector, name, points, params in self._detector_windows():
            verdict = (detectors.run_detector(detector, points, params, normalized=True)
                       if points else None)
            key = (detector, name)
            seen[key] = verdict is not None
            active = self._active.get(key)
            if verdict is None:
                continue
            if active is not None:
                active["verdict"] = verdict
                active["clean"] = 0
                continue
            finding = {"t": now, "detector": detector, "series": name, "verdict": verdict,
                       "window": points, "params": params}
            if detector == detectors.STALL:
                loop = name[len("loop."):] if name.startswith("loop.") else name
                finding["stacks"] = self.watchdog.stacks_for(loop)
            self._active[key] = {"verdict": verdict, "clean": 0}
            self._record_finding(finding)
            new_findings.append(finding)
        for key in list(self._active):
            if seen.get(key):
                continue
            active = self._active[key]
            active["clean"] += 1
            if active["clean"] >= self.policy.clear_samples:
                del self._active[key]
        return new_findings

    def _record_finding(self, finding: dict) -> None:
        with self._lock:
            self._findings.append(finding)
            if len(self._findings) > self.MAX_FINDINGS:
                self._findings.pop(0)
        metrics.TIMELINE_FINDINGS.labels(detector=finding["detector"],
                                         series=finding["series"]).inc()
        if self._flight is not None:
            self._flight.record_timeline_finding(
                t=finding["t"], detector=finding["detector"], series=finding["series"],
                window=[[t, v] for t, v in finding["window"]], params=finding["params"],
                verdict=finding["verdict"], stacks=finding.get("stacks", []))
        if self.recorder is not None and self._event_obj is not None:
            from nos_tpu_torch.api.v1alpha1.constants import EVENT_REASON_HEALTH_DEGRADED

            message = (f"{finding['detector']} finding on {finding['series']}: "
                       f"{json.dumps(finding['verdict'], sort_keys=True)}")
            self.recorder.record(self._event_obj, EVENT_REASON_HEALTH_DEGRADED, message,
                                 type="Warning")

    def findings(self, detector: Optional[str] = None) -> List[dict]:
        with self._lock:
            found = list(self._findings)
        if detector is not None:
            found = [f for f in found if f["detector"] == detector]
        return found

    def findings_payload(self) -> dict:
        """The findings without their windows and stacks."""
        return {"findings": [{"t": f["t"], "detector": f["detector"], "series": f["series"],
                              "verdict": f["verdict"]} for f in self.findings()]}

    # ------------------------------------------------------ rollups, debug

    @staticmethod
    def _rollup(values: List[float]) -> dict:
        return {"first": values[0], "last": values[-1], "min": min(values),
                "max": max(values), "delta": values[-1] - values[0], "points": len(values)}

    def rollups(self, window_seconds: Optional[float] = None) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name in self.names():
            points = self.series(name, window_seconds)
            if points:
                out[name] = self._rollup([v for _, v in points])
        return out

    def sparkline(self, name: str, points: int = 32,
                  window_seconds: Optional[float] = None) -> List[float]:
        """The series resampled evenly to ``points`` values."""
        series = self.series(name, window_seconds)
        if not series:
            return []
        if len(series) <= points:
            return [v for _, v in series]
        step = (len(series) - 1) / (points - 1)
        return [series[int(round(i * step))][1] for i in range(points)]

    def debug_payload(self, window_seconds: Optional[float] = None, spark_points: int = 32,
                      limit: int = 0, cursor: str = "") -> dict:
        """``/debug/timeline``: ``limit`` / ``cursor`` page the rollups and
        sparklines by series name; the summary covers the whole ring."""
        from nos_tpu_torch.obsplane.streaming import paginate

        names = self.names()
        page_names, next_cursor = paginate(names, limit, cursor)
        rollups: Dict[str, dict] = {}
        for name in page_names:
            points = self.series(name, window_seconds)
            if points:
                rollups[name] = self._rollup([v for _, v in points])
        return {
            "samples": self.samples, "retained": len(self), "capacity": self.capacity,
            "interval_seconds": self.interval_seconds, "series_count": len(rollups),
            "window_seconds": window_seconds, "watchdog": self.watchdog.debug_payload(),
            "active_findings": sorted(f"{d}:{s}" for d, s in list(self._active)),
            "findings": self.findings_payload()["findings"], "rollups": rollups,
            "sparklines": {name: self.sparkline(name, spark_points, window_seconds)
                           for name in rollups},
            "page": {"limit": limit, "cursor": cursor, "next_cursor": next_cursor,
                     "total_series": len(names)},
        }

    # ------------------------------------------------------ sampler thread

    def start(self) -> None:
        """One ``tick()`` an interval on a daemon thread, registered with
        the profiler and, as a periodic loop, with the watchdog."""
        if self._thread is not None:
            return
        self._stop_event.clear()
        self.watchdog.register("timeline-sampler", periodic=True,
                               thread_name="timeline-sampler")
        self._thread = threading.Thread(target=self._loop, name="timeline-sampler",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from nos_tpu_torch.util.profiling import PROFILER

        PROFILER.register_thread(name="timeline-sampler")
        try:
            while not self._stop_event.wait(self.interval_seconds):
                self.watchdog.beat("timeline-sampler")
                self.tick()
        finally:
            PROFILER.unregister_thread()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_event.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.watchdog.unregister("timeline-sampler")

    def close(self) -> None:
        """Detach the registry cursor (idempotent); a closed store samples
        full snapshots."""
        if self._cursor is not None:
            self._cursor.close()
            self._cursor = None
