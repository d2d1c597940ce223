"""The stack profiler (nos_tpu_torch.util.profiling), driven by
``sample_once()`` on fresh ``StackProfiler`` instances: no count of
samples from the background thread is asserted.

- Only registered threads are sampled; a thread parked in a known
  function shows its frames root first, under its name and its
  innermost tracing span (``(no-phase)`` outside one).
- ``collapsed()`` (one ``thread;phase;frames count`` line a stack, the
  overflow counted on its own line), ``top()``, ``phase_report()`` and
  ``reset()``.
- ``debug_payload()`` has the keys of the reference's
  (``nos_tpu.util.profiling.StackProfiler().debug_payload()``, a fresh
  instance, never started) and the same phase report shape.
- ``start()`` / ``stop()`` are idempotent and account overhead; the
  watchdog's ``stacks_for`` reads the process profiler's stacks of a
  loop's thread.
"""
import threading

import pytest

from nos_tpu.util.profiling import StackProfiler as RefStackProfiler
from nos_tpu_torch.timeline.watchdog import WedgeWatchdog
from nos_tpu_torch.util import profiling
from nos_tpu_torch.util.profiling import StackProfiler
from nos_tpu_torch.util.tracing import Tracer


def parked_here(ready, release):
    ready.set()
    release.wait(10)


def parked_in_a_span(tracer, ready, release):
    with tracer.span("planner.plan"):
        parked_here(ready, release)


@pytest.fixture
def parked():
    """A thread named 'loop-a' parked in ``parked_here`` under a span."""
    ready, release = threading.Event(), threading.Event()
    tracer = Tracer()
    thread = threading.Thread(target=parked_in_a_span, args=(tracer, ready, release),
                              name="loop-a", daemon=True)
    thread.start()
    assert ready.wait(10)
    yield thread
    release.set()
    thread.join(10)


def test_only_registered_threads_are_sampled(parked):
    prof = StackProfiler()
    assert prof.sample_once() == 0 and prof.collapsed() == ""
    prof.register_thread(ident=parked.ident, name="loop-a")
    assert prof.threads() == {parked.ident: "loop-a"}
    assert prof.sample_once() == 1 and prof.sample_once() == 1
    (line,) = prof.collapsed().splitlines()
    frames, count = line.rsplit(" ", 1)
    parts = frames.split(";")
    assert count == "2" and parts[:2] == ["loop-a", "planner.plan"]
    assert parts[2] == "threading.py:_bootstrap"  # root first
    assert parts[-3:] == ["test_torch_profiling.py:parked_here", "threading.py:wait",
                          "threading.py:wait"]
    assert prof.top(1) == [{"frame": "threading.py:wait", "samples": 2, "fraction": 1.0}]
    assert prof.phase_report() == {"total_samples": 2, "attributed_samples": 2,
                                   "attributed_fraction": 1.0, "phases": {"planner.plan": 2}}
    prof.unregister_thread(parked.ident)
    assert prof.sample_once() == 0


def test_a_thread_outside_a_span_has_no_phase():
    prof = StackProfiler()
    with prof.registered("main-loop"):
        assert prof.sample_once() == 1
    line = prof.collapsed().splitlines()[0]
    assert line.startswith("main-loop;(no-phase);")
    assert prof.phase_report()["attributed_fraction"] == 0.0
    assert prof.threads() == {}


def test_the_table_is_bounded_and_reset_clears_it(parked):
    prof = StackProfiler()
    prof.max_stacks = 1
    prof.register_thread(ident=parked.ident, name="loop-a")
    with prof.registered("other"):
        prof.sample_once()
        prof.sample_once()
    text = prof.collapsed()
    assert text.endswith("(table-overflow);(dropped) 2\n")
    assert prof.debug_payload()["dropped_stacks"] == 2 and prof.total_samples == 4
    prof.reset()
    assert prof.total_samples == 0 and prof.collapsed() == ""
    assert prof.threads() == {parked.ident: "loop-a"}  # registrations kept


def test_the_payload_has_the_references_keys(parked):
    ours, theirs = StackProfiler(), RefStackProfiler()
    assert set(ours.debug_payload()) == set(theirs.debug_payload())
    assert ours.debug_payload() == theirs.debug_payload()  # both empty, never started
    ours.register_thread(ident=parked.ident, name="loop-a")
    ours.sample_once()
    payload = ours.debug_payload(top_n=3)
    assert set(payload) == set(theirs.debug_payload())
    assert payload["threads"] == ["loop-a"] and payload["stacks"] == 1
    assert payload["enabled"] is False and payload["interval_seconds"] == 0.01
    assert len(payload["top"]) == 1


def test_start_and_stop_are_idempotent():
    prof = StackProfiler(interval_seconds=0.005)
    assert prof.start() and not prof.start()
    assert prof.enabled
    assert prof.stop() and not prof.stop()
    assert not prof.enabled
    assert prof.overhead_fraction() >= 0.0
    assert prof.start(interval_seconds=0.02) and prof.interval == 0.02
    prof.stop()


def test_the_watchdog_reads_a_loops_stacks_from_the_profiler(parked, monkeypatch):
    prof = StackProfiler()
    monkeypatch.setattr(profiling, "PROFILER", prof)
    watchdog = WedgeWatchdog()
    watchdog.register("loop-a", thread_name="loop-a")
    watchdog.register("quiet")
    prof.register_thread(ident=parked.ident, name="loop-a")
    prof.sample_once()
    stacks = watchdog.stacks_for("loop-a")
    assert len(stacks) == 1 and stacks[0].startswith("loop-a;planner.plan;")
    assert watchdog.stacks_for("quiet") == [] and watchdog.stacks_for("absent") == []
