"""The control-plane bench (nos_tpu_torch.bench_control_plane), bench.py's
half 2 on H100 nodes.

Its accounting functions are held against brute force: every
millisecond of the window sampled, on job times of the cluster's
0.05 s grid (so the sampling is exact). The whole bench runs at
``ControlPlaneSizes.reference()`` (4 one-GPU MIG nodes, the parity
tests' translation of the reference's 4 boards): its booleans are true,
every invariant holds after each phase, two runs with one seed give the
same virtual-clock keys, and incremental planning on and off give the
same placements and keys (but the plan modes). The reference's own
``run_control_plane_bench`` runs real controller threads on the wall
clock for about a minute, so it is not run here; CHANGES.md puts its
booleans beside these.
"""
import json
import random
import statistics

import pytest

from nos_tpu_torch import bench
from nos_tpu_torch import bench_control_plane as cp

REFERENCE_KEYS = ("utilization_pct", "p50_schedule_latency_ms", "stream_jobs_completed",
                  "pods_created", "slice_reconfigs_per_sec", "plans_applied", "preemptions",
                  "borrow_converged", "fair_share_restored", "admission_rejects",
                  "multihost_gang_formed", "multihost_time_to_running_s")
STEP = 0.05
MS = 0.001


def _grid(rng, lo, hi):
    return round(rng.randint(int(lo / STEP), int(hi / STEP)) * STEP, 10)


def _random_jobs(rng, n=40):
    jobs = []
    for _ in range(n):
        bound = _grid(rng, 0.0, 9.0) if rng.random() < 0.9 else None
        finished = None
        if bound is not None and rng.random() < 0.8:
            finished = round(bound + _grid(rng, 0.05, 4.0), 10)
        jobs.append(cp.Job(rng.choice([10, 20, 40, 80]), bound, finished))
    return jobs


def _held_at(jobs, t, w1):
    return sum(j.gb for j in jobs if j.bound is not None and j.bound <= t
               < (w1 if j.finished is None else j.finished))


def _brute_utilization(jobs, w0, w1, fleet):
    n = round((w1 - w0) / MS)
    return 100.0 * sum(_held_at(jobs, w0 + (i + 0.5) * MS, w1) for i in range(n)) / (n * fleet)


@pytest.mark.parametrize("seed", range(4))
def test_event_utilization_and_series_match_sampling(seed):
    rng = random.Random(seed)
    jobs, fleet = _random_jobs(rng), 320
    w0, w1 = 2.5, 10.35
    assert cp.event_utilization(jobs, w0, w1, fleet) == pytest.approx(
        _brute_utilization(jobs, w0, w1, fleet), rel=1e-9)
    series = cp.per_second_series(jobs, w0, w1, fleet)
    assert len(series) == int(w1 - w0)
    for s, value in enumerate(series):
        a0, a1 = w0 + s, min(w0 + s + 1, w1)
        assert value == pytest.approx(_brute_utilization(jobs, a0, a1, fleet), rel=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_idle_attribution_matches_sampling(seed):
    rng = random.Random(100 + seed)
    fleet, samples, t = 320, [], 0.0
    while t < 10.0:
        dt = STEP * rng.randint(1, 3)
        samples.append((t, round(t + dt, 10), rng.choice([0, 40, 120, 320]),
                        rng.choice([0, 10, 80, 200])))
        t = round(t + dt, 10)
    w0, w1 = 2.5, 9.0
    n = round((w1 - w0) / MS)
    ineff = starved = 0.0
    for i in range(n):
        at = w0 + (i + 0.5) * MS
        _, _, idle, pending = next(s for s in samples if s[0] <= at < s[1])
        ineff += min(idle, pending)
        starved += idle - min(idle, pending)
    got = cp.idle_attribution(samples, w0, w1, fleet)
    assert got["idle_with_pending_pct"] == pytest.approx(100 * ineff / (n * fleet), rel=1e-9)
    assert got["idle_no_pending_pct"] == pytest.approx(100 * starved / (n * fleet), rel=1e-9)


def test_waits_by_size_matches_a_sort():
    rng = random.Random(7)
    waits = [(rng.choice(["1g.10gb", "3g.40gb", "7g.80gb"]), _grid(rng, 0, 4))
             for _ in range(30)]
    got = cp.waits_by_size(waits)
    for profile in {p for p, _ in waits}:
        ws = sorted(w for p, w in waits if p == profile)
        mid = len(ws) // 2
        median = ws[mid] if len(ws) % 2 else (ws[mid - 1] + ws[mid]) / 2
        assert got[profile] == {"n": len(ws), "p50_s": median, "max_s": ws[-1],
                                "sum_s": sum(ws)}
    assert sorted(got) == sorted({p for p, _ in waits})


# ------------------------------------------------------------ the bench

@pytest.fixture(scope="module")
def runs():
    """The bench at reference sizes: seed 0 twice, and seed 0 with
    incremental planning off."""
    sizes = cp.ControlPlaneSizes.reference()
    return (cp.run_control_plane_bench(sizes, seed=0),
            cp.run_control_plane_bench(sizes, seed=0),
            cp.run_control_plane_bench(sizes, seed=0, incremental_planning=False))


def test_reference_sizes_converge_and_hold_every_invariant(runs):
    result = runs[0]
    assert set(REFERENCE_KEYS) <= set(result)
    for key in ("borrow_converged", "fair_share_restored", "multihost_gang_formed",
                "fill_converged", "invariants_hold"):
        assert result[key] is True, key
    assert all(all(checks.values()) for checks in result["invariants"].values())
    assert set(result["invariants"]) == {"fill", "stream", "contention", "churn", "multihost"}
    assert all(turn["converged"] for turn in result["churn_turns"])
    assert result["multihost_members"] == 4 and result["multihost_pools"] == [""]
    assert result["preemptions"] > 0 and result["stream_jobs_completed"] > 0
    assert 0 < result["utilization_pct"] <= 100
    assert result["sizes"]["fleet_gb"] == 320
    # the stream's second-by-second view covers its steady window
    assert len(result["utilization_per_second_pct"]) == int(result["stream_window_s"])
    assert result["plan_modes"].get("incremental", 0) > 0
    json.dumps(result)


def test_one_seed_repeats_every_virtual_key(runs):
    first, second, _ = runs
    assert cp.virtual_keys(first) == cp.virtual_keys(second)
    assert set(first["wall_s"]) == {"fill", "stream", "contention", "churn", "multihost"}


def test_incremental_planning_on_and_off_place_alike(runs):
    on, _, off = runs
    assert off["plan_modes"] == {"full": off["plan_modes"]["full"]}
    assert on["placement_digest"] == off["placement_digest"]
    skip = {"plan_modes", "incremental_planning"}
    assert ({k: v for k, v in cp.virtual_keys(on).items() if k not in skip}
            == {k: v for k, v in cp.virtual_keys(off).items() if k not in skip})


def test_bench_prints_the_merged_line(runs, monkeypatch, capsys, tmp_path):
    seen = {}

    def fake(sizes, **kwargs):
        seen["sizes"] = sizes
        return runs[0]

    monkeypatch.setattr(cp, "run_control_plane_bench", fake)
    out = tmp_path / "line.json"
    assert bench.main(["--control-plane-only", "--control-plane-sizes", "reference",
                       "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen["sizes"] == cp.ControlPlaneSizes.reference()
    assert line["metric"] == "gpu_memory_utilization" and line["unit"] == "%"
    assert line["value"] == runs[0]["utilization_pct"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 90.0)
    assert "utilization_pct" not in line
    assert all(line[k] == runs[0][k] for k in REFERENCE_KEYS[1:])
    assert json.loads(out.read_text()) == line


def test_sizes_mean_what_the_header_says():
    quick, card = cp.ControlPlaneSizes.quick(), cp.ControlPlaneSizes.card()
    assert (quick.gpus, quick.multihost_gpus, quick.stream_s) == (64, 64, 8.0)
    assert (card.gpus, card.fleet_gb, card.multihost_gpus, card.stream_s) == (
        256, 20480, 64, 20.0)
    assert statistics.mean([cp.profile_gb(p) for p in cp.FORTY]) == 40
