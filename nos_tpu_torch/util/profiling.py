"""The control plane's sampling profiler: counterpart of
``nos_tpu/util/profiling.py``.

``StackProfiler`` samples ``sys._current_frames()`` on a daemon thread
(100 Hz by default), and only the threads that registered themselves
(``register_thread()`` in the thread's body, or ``registered()``): the
controllers' pumps and workers, the partitioner's batch loops, the
timeline sampler. Samples collapse into a ``(thread, phase, stack) →
count`` table of at most ``MAX_STACKS`` entries (an overflow is counted,
not kept); a frame is ``file.py:function``. The phase is the thread's
innermost open tracing span (``tracing.current_phase``), "(no-phase)"
outside one. The sampler accounts its own busy time against the wall
time it ran (``overhead_fraction``, the
``nos_tpu_profiler_overhead_fraction`` gauge).

Read as ``collapsed()`` (flamegraph.pl / speedscope input, the thread
and phase as the two root frames), ``top(n)`` (frames by self time),
``phase_report()`` and ``debug_payload()`` (``/debug/profile``).
``sample_once()`` takes one sample in the caller's thread.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from nos_tpu_torch.util import metrics, tracing


class StackProfiler:
    DEFAULT_INTERVAL = 0.01  # 100 Hz
    MAX_STACKS = 2048
    MAX_DEPTH = 48

    def __init__(self, interval_seconds: float = DEFAULT_INTERVAL) -> None:
        self.interval = interval_seconds
        self.max_stacks = self.MAX_STACKS
        self.max_depth = self.MAX_DEPTH
        self._lock = threading.Lock()
        self._threads: Dict[int, str] = {}
        # code object → "file.py:function", touched by the sampler only
        self._frame_labels: Dict[Any, str] = {}
        self._table: Dict[Tuple[str, str, Tuple[str, ...]], int] = {}
        self._phase_samples: Dict[str, int] = {}
        self._total_samples = 0
        self._dropped_stacks = 0
        # the sampler's busy seconds against the wall seconds it ran
        self._busy_s = 0.0
        self._wall_accum = 0.0
        self._started_at = 0.0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- registration

    def register_thread(self, name: Optional[str] = None,
                        ident: Optional[int] = None) -> int:
        """Sample this thread (or ``ident``); its id."""
        if ident is None:
            ident = threading.get_ident()
            name = name or threading.current_thread().name
        with self._lock:
            self._threads[ident] = name or str(ident)
        return ident

    def unregister_thread(self, ident: Optional[int] = None) -> None:
        if ident is None:
            ident = threading.get_ident()
        with self._lock:
            self._threads.pop(ident, None)

    @contextlib.contextmanager
    def registered(self, name: Optional[str] = None):
        """Sample the calling thread for the block."""
        ident = self.register_thread(name)
        try:
            yield self
        finally:
            self.unregister_thread(ident)

    def threads(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._threads)

    # ---------------------------------------------------------- lifecycle

    @property
    def enabled(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def start(self, interval_seconds: Optional[float] = None) -> bool:
        """Start the sampler; False when it runs already."""
        with self._lock:
            if interval_seconds is not None:
                self.interval = interval_seconds
            if self._thread is not None and self._thread.is_alive():
                return False
            stop = threading.Event()
            thread = threading.Thread(target=self._run, args=(stop,), name="stack-profiler",
                                      daemon=True)
            self._stop, self._thread = stop, thread
            self._started_at = time.perf_counter()
            # under the lock: a stop() that takes it next joins a live thread
            thread.start()
        return True

    def stop(self) -> bool:
        """Stop and join the sampler; False when it was not running."""
        with self._lock:
            thread, stop = self._thread, self._stop
            self._thread = self._stop = None
            if thread is not None:
                self._wall_accum += time.perf_counter() - self._started_at
        if thread is None or stop is None:
            return False
        stop.set()
        thread.join(timeout=2.0)
        return True

    def reset(self) -> None:
        """Drop the samples and the overhead account (the registrations
        and a running sampler stay)."""
        with self._lock:
            self._table.clear()
            self._phase_samples.clear()
            self._total_samples = 0
            self._dropped_stacks = 0
            self._busy_s = 0.0
            self._wall_accum = 0.0
            self._started_at = time.perf_counter()

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            t0 = time.perf_counter()
            self.sample_once()
            with self._lock:
                self._busy_s += time.perf_counter() - t0
            metrics.PROFILER_OVERHEAD.set(round(self.overhead_fraction(), 6))

    # ----------------------------------------------------------- sampling

    def sample_once(self) -> int:
        """One sample of every registered thread; the threads sampled."""
        with self._lock:
            targets = list(self._threads.items())
        if not targets:
            return 0
        labels = self._frame_labels
        if len(labels) > 8192:  # code churn (reloads, lambdas)
            labels.clear()
        frames = sys._current_frames()
        keys: List[Tuple[str, str, Tuple[str, ...]]] = []
        for ident, name in targets:
            frame = frames.get(ident)
            if frame is None:
                continue
            stack: List[str] = []
            while frame is not None and len(stack) < self.max_depth:
                code = frame.f_code
                label = labels.get(code)
                if label is None:
                    label = labels[code] = (f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                            f"{code.co_name}")
                stack.append(label)
                frame = frame.f_back
            stack.reverse()  # root first, as collapsed stacks are
            keys.append((name, tracing.current_phase(ident), tuple(stack)))
        del frames
        if not keys:
            return 0
        with self._lock:
            for key in keys:
                self._total_samples += 1
                phase = key[1]
                self._phase_samples[phase] = self._phase_samples.get(phase, 0) + 1
                if key in self._table or len(self._table) < self.max_stacks:
                    self._table[key] = self._table.get(key, 0) + 1
                else:
                    self._dropped_stacks += 1
        metrics.PROFILER_SAMPLES.inc(len(keys))
        return len(keys)

    # ---------------------------------------------------------- reporting

    @property
    def total_samples(self) -> int:
        with self._lock:
            return self._total_samples

    def overhead_fraction(self) -> float:
        """Busy seconds over the wall seconds sampled since ``reset()``."""
        with self._lock:
            wall = self._wall_accum
            if self._thread is not None and self._thread.is_alive():
                wall += time.perf_counter() - self._started_at
            busy = self._busy_s
        return busy / wall if wall > 0 else 0.0

    def collapsed(self) -> str:
        """``thread;phase;frame;...;frame count``, one line a stack."""
        with self._lock:
            items = sorted(self._table.items())
            dropped = self._dropped_stacks
        lines = [f"{';'.join([name, phase or '(no-phase)', *stack])} {count}"
                 for (name, phase, stack), count in items]
        if dropped:
            lines.append(f"(table-overflow);(dropped) {dropped}")
        return "\n".join(lines) + ("\n" if lines else "")

    def top(self, n: int = 20) -> List[Dict[str, Any]]:
        """The ``n`` frames of most self time (leaf samples)."""
        with self._lock:
            items = list(self._table.items())
            total = self._total_samples
        self_counts: Dict[str, int] = {}
        for (_, _, stack), count in items:
            leaf = stack[-1] if stack else "(unknown)"
            self_counts[leaf] = self_counts.get(leaf, 0) + count
        ranked = sorted(self_counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        return [{"frame": frame, "samples": count,
                 "fraction": round(count / total, 4) if total else 0.0}
                for frame, count in ranked]

    def phase_report(self) -> Dict[str, Any]:
        """Samples by phase and the share a span explains."""
        with self._lock:
            phases = dict(self._phase_samples)
            total = self._total_samples
        attributed = sum(count for phase, count in phases.items() if phase)
        return {"total_samples": total, "attributed_samples": attributed,
                "attributed_fraction": round(attributed / total, 4) if total else 0.0,
                "phases": {phase or "(no-phase)": count
                           for phase, count in sorted(phases.items(), key=lambda kv: -kv[1])}}

    def debug_payload(self, top_n: int = 20) -> Dict[str, Any]:
        """``/debug/profile``'s document."""
        with self._lock:
            stacks = len(self._table)
            dropped = self._dropped_stacks
        return {"enabled": self.enabled, "interval_seconds": self.interval,
                "threads": sorted(self.threads().values()), "stacks": stacks,
                "dropped_stacks": dropped,
                "overhead_fraction": round(self.overhead_fraction(), 6),
                **self.phase_report(), "top": self.top(top_n)}


# the process-wide profiler of the port
PROFILER = StackProfiler()
