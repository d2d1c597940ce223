"""The metrics registry's governor, cursor and child delete
(nos_tpu_torch.util.metrics) against nos_tpu.util.metrics.

Fresh ``MetricsRegistry`` instances on both sides take one seeded
emission stream (counters, gauges and histograms, labeled and bare,
``remove`` of present and absent children, budgets applied per family and
by default before and during the stream, then restored), with a
``SnapshotCursor`` on each collecting between bursts: every cursor delta
(changed series and removed keys), the final ``render()`` bytes,
``snapshot()`` and ``series_report()`` are exactly equal. The governor's
fold keeps counter sums; a second cursor sees every delta on its own; a
removed child's slot counts against the budget again while the dropped
count stays. The process's registries are not touched.
"""
import numpy as np
import pytest

from nos_tpu.util import metrics as jm
from nos_tpu_torch.util import metrics as tm

FAMILIES = (("counter", "nos_tpu_obs_c_total", "c help"), ("gauge", "nos_tpu_obs_g", "g help"),
            ("histogram", "nos_tpu_obs_h_seconds", "h help"),
            ("counter", "nos_tpu_obs_bare_total", "bare"))
LABELS = [{"node": f"n{i:02d}"} for i in range(12)] + [
    {"node": f"n{i:02d}", "state": s} for i in range(6) for s in ("used", "free")] + [{}]


def _family(reg, kind, name, help_text):
    return getattr(reg, kind)(name, help_text)


def _stream(seed, steps=300):
    """A seeded list of operations, one package-neutral tuple each."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(steps):
        r = float(rng.random())
        fam = int(rng.integers(0, len(FAMILIES)))
        labels = LABELS[int(rng.integers(0, len(LABELS)))]
        if fam == 3:
            labels = {}
        amount = float(rng.integers(1, 50)) / 4.0
        if r < 0.04:
            ops.append(("budgets", {FAMILIES[int(rng.integers(0, 3))][1]: int(rng.integers(1, 6))},
                        int(rng.integers(3, 9)) if rng.random() < 0.5 else None))
        elif r < 0.06:
            ops.append(("restore",))
        elif r < 0.16:
            ops.append(("remove", fam, labels))
        elif r < 0.26:
            ops.append(("collect",))
        else:
            ops.append(("emit", fam, labels, amount))
    ops.append(("collect",))
    return ops


def _apply(reg, cursor, op, saved):
    kind = op[0]
    if kind == "budgets":
        saved.append(reg.apply_series_budgets(op[1], default=op[2]))
    elif kind == "restore":
        if saved:
            reg.restore_series_budgets(saved.pop())
    elif kind == "remove":
        _, fam, labels = op
        return _family(reg, *FAMILIES[fam]).remove(**labels)
    elif kind == "collect":
        return cursor.collect()
    else:
        _, fam, labels, amount = op
        family = _family(reg, *FAMILIES[fam])
        series = family.labels(**labels) if labels else family
        if FAMILIES[fam][0] == "counter":
            series.inc(amount)
        elif FAMILIES[fam][0] == "gauge":
            series.set(amount)
        else:
            series.observe(amount)
    return None


@pytest.mark.parametrize("seed", range(8))
def test_the_governed_stream_renders_the_references_bytes(seed):
    ref, port = jm.MetricsRegistry(), tm.MetricsRegistry()
    ref.apply_series_budgets({"nos_tpu_obs_g": 4}, default=None)
    port.apply_series_budgets({"nos_tpu_obs_g": 4}, default=None)
    ref_cursor, port_cursor = ref.cursor(), port.cursor()
    ref_saved, port_saved = [], []
    for op in _stream(seed):
        got = _apply(port, port_cursor, op, port_saved)
        want = _apply(ref, ref_cursor, op, ref_saved)
        assert got == want, op
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    assert port.series_report() == ref.series_report()
    ref_cursor.close()
    port_cursor.close()


def test_a_stream_folds_and_drops():
    """The parity streams reach the fold: the first exact label sets stay,
    later ones land in _other, counted once each, and sums are kept."""
    reg = tm.MetricsRegistry()
    reg.apply_series_budgets({"nos_tpu_obs_c_total": 3})
    c = reg.counter("nos_tpu_obs_c_total", "c")
    for i in range(6):
        c.labels(node=f"n{i}").inc(i + 1)
    c.labels(node="n5").inc(10)  # a refused set again: no new drop
    report = reg.series_report()["nos_tpu_obs_c_total"]
    assert report == {"exact": 3, "overflow": 1, "dropped": 3, "budget": 3}
    assert c.labels(node="_other").value == 4 + 5 + 6 + 10
    assert c.total == sum(range(1, 7)) + 10
    assert reg.counter(tm.METRIC_SERIES_DROPPED_NAME).labels(
        family="nos_tpu_obs_c_total").value == 3
    assert 'nos_tpu_obs_c_total{node="_other"} 25.0' in reg.render()
    # a removed exact child frees its slot; the dropped count stays
    assert c.remove(node="n0") and not c.remove(node="n0")
    c.labels(node="n9").inc()
    assert reg.series_report()["nos_tpu_obs_c_total"] == {
        "exact": 3, "overflow": 1, "dropped": 3, "budget": 3}
    assert 'node="n9"' in reg.render() and 'node="n0"' not in reg.render()


def test_budgets_apply_to_families_made_later_and_restore():
    """A budget given before its family exists applies when it is made;
    restore puts back the budgets of the families that existed (one made
    in between keeps its budget, as in the reference)."""
    reports = []
    for m in (jm, tm):
        reg = m.MetricsRegistry()
        reg.counter("early_total", "e").labels(k="0").inc()
        prev = reg.apply_series_budgets({"later": 1}, default=2)
        g = reg.gauge("later", "l")
        for i in range(3):
            g.labels(k=str(i)).set(i)
        h = reg.histogram("other", "o")
        for i in range(4):
            h.labels(k=str(i)).observe(i)
        for i in range(4):
            reg.counter("early_total").labels(k=str(i)).inc()
        before = reg.series_report()
        reg.restore_series_budgets(prev)
        g.labels(k="new").set(1)
        reg.counter("early_total").labels(k="9").inc()
        reports.append((before, reg.series_report(), reg.render()))
    assert reports[1] == reports[0]
    before, after, _ = reports[1]
    assert before["later"]["exact"] == 1 and before["other"]["exact"] == 2
    assert before["early_total"] == {"exact": 2, "overflow": 1, "dropped": 2, "budget": 2}
    assert after["early_total"]["budget"] is None and after["early_total"]["exact"] == 3


def test_two_cursors_each_see_every_delta():
    """Each cursor sees every change and removal on its own (a change may
    come twice across windows, never not at all)."""
    seen = []
    for m in (jm, tm):
        reg = m.MetricsRegistry()
        c = reg.counter("x_total", "x")
        a = reg.cursor()
        out = [a.collect()]
        c.labels(k="1").inc()
        b = reg.cursor()
        out.append(b.collect())
        c.labels(k="2").inc()
        out += [a.collect(), b.collect()]
        c.remove(k="1")
        c.labels(k="2").inc()
        out.append(a.collect())
        a.close()
        c.labels(k="3").inc()
        out.append(b.collect())
        out.append(a in reg._cursors)
        seen.append(out)
    assert seen[1] == seen[0]
    out = seen[1]
    assert out[0] == ({}, [])  # the prime: nothing touched yet
    assert out[2] == ({'x_total{k="1"}': 1.0, 'x_total{k="2"}': 1.0}, [])
    assert out[4] == ({'x_total{k="2"}': 2.0}, ['x_total{k="1"}'])
    assert out[5] == ({'x_total{k="2"}': 2.0, 'x_total{k="3"}': 1.0}, ['x_total{k="1"}'])
    assert out[6] is False


def test_the_port_registry_keeps_the_reference_families_of_the_plane():
    for name in ("PROFILER_SAMPLES", "PROFILER_OVERHEAD", "TIMELINE_SAMPLES", "TIMELINE_SERIES",
                 "TIMELINE_FINDINGS", "TIMELINE_SAMPLE_DURATION", "METRIC_SERIES_DROPPED",
                 "TRACE_RETAINED"):
        ours, theirs = getattr(tm, name), getattr(jm, name)
        assert (ours.name, ours.help, type(ours).__name__) == \
            (theirs.name, theirs.help, type(theirs).__name__), name
    assert tm.TIMELINE_SAMPLE_DURATION.buckets == jm.TIMELINE_SAMPLE_DURATION.buckets
    assert set(tm.LABEL_RESET_EXEMPT) <= set(jm.LABEL_RESET_EXEMPT)
    assert set(tm.LABEL_RESET_PATHS) <= set(jm.LABEL_RESET_PATHS)


def test_histogram_percentiles_read_the_window():
    reg, ref = tm.MetricsRegistry(), jm.MetricsRegistry()
    for r in (reg, ref):
        h = r.histogram("lat_seconds", "l", buckets=(0.1, 1.0))
        for v in range(1, 2001):
            h.labels(route="a").observe(v / 1000.0)
    assert reg.snapshot() == ref.snapshot()
    assert reg.histogram("lat_seconds").labels(route="a").percentile(50) == \
        ref.histogram("lat_seconds").labels(route="a").percentile(50)
    assert reg.render() == ref.render()
