"""Pure detectors over timeline windows: counterpart of
``nos_tpu/timeline/detectors.py``.

Each takes a window of ``(timestamp, value)`` points of one series and
returns None (healthy) or a JSON-ready verdict; no clock, no global, no
randomness, so the same window gives the same verdict bit for bit.

- **stall**: a counter a loop bumps stays flat for ``flat_windows``
  sample intervals after it had moved.
- **leak**: a size grows past ``budget`` across the window, mostly
  monotonically, with a positive Theil–Sen slope (the median of the
  pairwise slopes, so one reset or spike neither fakes nor hides it).
- **regression**: the median of the recent points rises past ``ratio``
  times the median of the first (baseline) points.

The hysteresis (a finding fires once, clears after quiet samples) lives
in ``TimelineStore.check``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Point = Tuple[float, float]

STALL = "stall"
LEAK = "leak"
REGRESSION = "regression"

DEFAULT_STALL_WINDOWS = 5
DEFAULT_LEAK_BUDGET = 256.0
DEFAULT_LEAK_MIN_POINTS = 8
DEFAULT_LEAK_MONOTONIC_FRACTION = 0.9
DEFAULT_REGRESSION_RATIO = 1.5
DEFAULT_REGRESSION_MIN_POINTS = 8


def median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def theil_sen_slope(points: Sequence[Point]) -> float:
    """The median of every pairwise slope (pairs without a time step
    skipped); 0.0 without one."""
    slopes: List[float] = []
    for i in range(len(points)):
        for j in range(i + 1, len(points)):
            dt = points[j][0] - points[i][0]
            if dt > 0:
                slopes.append((points[j][1] - points[i][1]) / dt)
    return median(slopes) if slopes else 0.0


def detect_stall(points: Sequence[Point], *,
                 flat_windows: int = DEFAULT_STALL_WINDOWS) -> Optional[dict]:
    """The counter did not move across the last ``flat_windows``
    intervals, having moved before (a loop that never ran is a wiring
    fault, not a wedge)."""
    if len(points) < flat_windows + 1:
        return None
    tail = points[-(flat_windows + 1):]
    if any(b[1] > a[1] for a, b in zip(tail, tail[1:])):
        return None
    if tail[-1][1] <= 0:
        return None
    return {"detector": STALL, "flat_windows": flat_windows, "flat_since": tail[0][0],
            "last_value": tail[-1][1]}


def detect_leak(points: Sequence[Point], *, budget: float = DEFAULT_LEAK_BUDGET,
                min_points: int = DEFAULT_LEAK_MIN_POINTS,
                monotonic_fraction: float = DEFAULT_LEAK_MONOTONIC_FRACTION
                ) -> Optional[dict]:
    """Growth past ``budget`` across the window, at least
    ``monotonic_fraction`` of the steps non-decreasing, and a positive
    slope (a ring filling up plateaus, a churning cache dips)."""
    if len(points) < min_points:
        return None
    growth = points[-1][1] - points[0][1]
    if growth <= budget:
        return None
    steps = [b[1] - a[1] for a, b in zip(points, points[1:])]
    if sum(1 for s in steps if s >= 0) < monotonic_fraction * len(steps):
        return None
    slope = theil_sen_slope(points)
    if slope <= 0:
        return None
    return {"detector": LEAK, "growth": growth, "budget": budget,
            "slope_per_second": slope, "window_seconds": points[-1][0] - points[0][0]}


def detect_regression(points: Sequence[Point], *,
                      baseline_points: int = DEFAULT_REGRESSION_MIN_POINTS,
                      recent_points: int = DEFAULT_REGRESSION_MIN_POINTS,
                      ratio: float = DEFAULT_REGRESSION_RATIO,
                      abs_floor: float = 0.0) -> Optional[dict]:
    """The recent median against the baseline median; ``abs_floor``
    silences verdicts on a baseline so small the ratio is noise."""
    if len(points) < baseline_points + recent_points:
        return None
    baseline = median([v for _, v in points[:baseline_points]])
    recent = median([v for _, v in points[-recent_points:]])
    if baseline <= 0:
        return None
    if recent <= baseline * ratio or recent - baseline <= abs_floor:
        return None
    return {"detector": REGRESSION, "baseline": baseline, "recent": recent,
            "ratio": recent / baseline, "threshold_ratio": ratio}


def run_detector(detector: str, points: Sequence[Point], params: dict, *,
                 normalized: bool = False) -> Optional[dict]:
    """The one entry point of the live engine and of a recomputation.
    ``normalized=True`` skips the float coercion for windows already of
    float pairs (the store's); a window read from JSON passes False."""
    fns = {STALL: detect_stall, LEAK: detect_leak, REGRESSION: detect_regression}
    if not normalized:
        points = [(float(t), float(v)) for t, v in points]
    return fns[detector](points, **params)
