"""Forecast-accuracy calibration: counterpart of
``nos_tpu/forecast/accuracy.py:26-89`` (``nearest_rank``,
``CalibrationTracker``).

Each published gang forecast is joined, when the capacity ledger sees
the gang bind, against the observed bind time; the tracker keeps the
absolute ETA errors and the errors over the gang's whole wait, and
publishes their p50 and p95: the gate is "p95 absolute ETA error <= 25%
of the actual wait". Nearest-rank percentiles over a bounded window, no
wall clock: the payload is a pure function of the ``add`` history.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_WINDOW = 512


def nearest_rank(sorted_values: List[float], quantile: float) -> float:
    """The ceil(q * n)-th smallest value, 1-indexed; 0.0 when empty."""
    if not sorted_values:
        return 0.0
    n = len(sorted_values)
    rank = int(quantile * n)
    if rank * 1.0 < quantile * n:  # ceil without float surprises
        rank += 1
    rank = min(max(rank, 1), n)
    return sorted_values[rank - 1]


class CalibrationTracker:
    """Forecast against observed over the last ``window`` gang binds."""

    def __init__(self, window: int = DEFAULT_WINDOW) -> None:
        self._samples: deque = deque(maxlen=window)
        self.joined = 0  # outcomes with an ETA to score
        self.unforecast = 0  # gangs bound while their ETA was None

    def add(self, eta_seconds: Optional[float], actual_seconds: float, wait_seconds: float,
            stage: str = "") -> Optional[Dict[str, float]]:
        """Join one gang bind against its last forecast: ``actual_seconds``
        from the forecast's stamp to the bind, ``wait_seconds`` the gang's
        arrival-to-bound wait. The sample, or None without an ETA."""
        if eta_seconds is None:
            self.unforecast += 1
            return None
        error = abs(eta_seconds - actual_seconds)
        ratio = error / wait_seconds if wait_seconds > 0 else 0.0
        sample = {"error_seconds": error, "ratio": ratio, "stage": stage}
        self._samples.append(sample)
        self.joined += 1
        return sample

    def payload(self) -> Dict[str, Any]:
        errors = sorted(s["error_seconds"] for s in self._samples)
        ratios = sorted(s["ratio"] for s in self._samples)
        # None, not 0.0, with no sample: no evidence is not a perfect score
        return {
            "samples": len(self._samples),
            "joined": self.joined,
            "unforecast": self.unforecast,
            "p50_error_seconds": nearest_rank(errors, 0.50) if errors else None,
            "p95_error_seconds": nearest_rank(errors, 0.95) if errors else None,
            "p50_ratio": nearest_rank(ratios, 0.50) if ratios else None,
            "p95_ratio": nearest_rank(ratios, 0.95) if ratios else None,
        }
