"""Kernel timing on the card, shared by ``chip_smoke.py`` and
``ops/flash_fwd_bench.py``.

Two clocks, which differ where the host takes longer to launch a call
than the card takes to run it (small shapes): CUDA events around each
call, and the device time of the kernels a call launches, summed by
torch.profiler.
"""
from __future__ import annotations

import statistics


def event_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, reps: int = 10) -> "float | None":
    """Mean device time per call of the kernels ``fn`` launches. A
    profile that recorded no device event at all (the tracer dropped the
    window) is taken again, three times in all; then None (not measured,
    null in JSON), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                total_us += ev.self_cuda_time_total if us is None else us
        if total_us > 0:
            return total_us / reps / 1e3
    return None
