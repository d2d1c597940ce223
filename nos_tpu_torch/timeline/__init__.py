"""The health timeline: counterpart of ``nos_tpu/timeline/``.

``TimelineStore`` samples the metrics registry, the process's vitals,
the ``SizeRegistry`` and the ``WedgeWatchdog``'s loop counters into a
bounded delta-encoded ring, and runs the pure detectors of
``detectors.py`` (stall, leak, regression) over it.
"""
from nos_tpu_torch.timeline import detectors
from nos_tpu_torch.timeline.detectors import (
    LEAK,
    REGRESSION,
    STALL,
    detect_leak,
    detect_regression,
    detect_stall,
    run_detector,
)
from nos_tpu_torch.timeline.sizes import SIZES, SizeRegistry
from nos_tpu_torch.timeline.store import DetectorPolicy, TimelineStore
from nos_tpu_torch.timeline.watchdog import WATCHDOG, WedgeWatchdog

__all__ = ["detectors", "LEAK", "REGRESSION", "STALL", "detect_leak", "detect_regression",
           "detect_stall", "run_detector", "SIZES", "SizeRegistry", "DetectorPolicy",
           "TimelineStore", "WATCHDOG", "WedgeWatchdog"]
