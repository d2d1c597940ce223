"""The port's SLO package (nos_tpu_torch.slo) against the reference's.

- ``SLOSpec.parse`` case by case: the same fields, or the same error.
- ``build_arrivals`` gives the reference's arrival stream exactly (both
  draw from ``random.Random(seed)`` in one order), ``percentiles`` the
  same nearest-rank values.
- ``bench_serve.run`` (``--duration 8 --rate 3``, the tiny Llama on
  weights bridged from the reference's seed-0 init) gives the report of
  the repository's ``bench_serve.run`` on the same workload: every key
  the same, every number within 1e-9. The one block left out of the
  comparison is the port's ``wall`` (the drive's wall seconds and
  tokens/s, which the reference does not report).
- ``OpenLoopDriver`` refuses a wall clock, opens a ``serve.drive`` span per
  model, and the SLO gauges land in the port's registry under the
  reference's names.
- ``--card`` refuses to run anywhere but on the GPU, and calibration
  refuses params that are not on the card.
"""
import argparse

import jax
import numpy as np
import pytest

import bench_serve as ref_bench
from nos_tpu.models import llama as jl
from nos_tpu.slo import driver as ref_driver
from nos_tpu.slo import engine as ref_engine
from nos_tpu_torch.bridge import params_from_numpy
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.serve import Engine, ServeTelemetry
from nos_tpu_torch.slo import bench_serve, driver, engine
from nos_tpu_torch.util.metrics import REGISTRY
from nos_tpu_torch.util.tracing import TRACER

NUM_TOL = 1e-9

_SPECS = [
    "p95 ttft < 500ms", "p99 e2e < 3s", "p50 tpot < 20ms", "availability 99%",
    "  P99.9 queue_wait < 1.5s ", "p50 ttft<250ms", "availability 99.95%",
    # refused
    "p95 latency < 5ms", "p100 ttft < 1s", "p0 ttft < 1s", "availability 100%",
    "p95 ttft > 5ms", "ttft < 5ms", "", "availability 0%",
]


@pytest.mark.parametrize("text", _SPECS)
def test_slo_spec_parse_matches_reference(text):
    try:
        want = ref_engine.SLOSpec.parse(text)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            engine.SLOSpec.parse(text)
        assert str(got.value) == str(exc)
        return
    got = engine.SLOSpec.parse(text)
    assert (got.raw, got.name, got.metric, got.objective, got.threshold_s) == (
        want.raw, want.name, want.metric, want.objective, want.threshold_s)


def _workload(module, seed=3, amplitude=0.5):
    profiles = (module.ModelProfile(name="hot", weight=0.8),
                module.ModelProfile(name="cold", weight=0.2, prompt_tokens=(4, 9),
                                    max_new_tokens=(2, 5), adapter=1))
    return module.WorkloadConfig(seed=seed, duration_s=30.0, rate_rps=4.0,
                                 diurnal_amplitude=amplitude, diurnal_period_s=15.0,
                                 models=profiles)


@pytest.mark.parametrize("seed,amplitude", [(0, 0.0), (3, 0.5), (11, 1.0)])
def test_arrivals_and_percentiles_match_reference(seed, amplitude):
    want = ref_driver.build_arrivals(_workload(ref_driver, seed, amplitude))
    got = driver.build_arrivals(_workload(driver, seed, amplitude))
    assert len(got) == len(want) > 50
    for g, w in zip(got, want):
        assert (g.t, g.model, g.prompt, g.max_new_tokens, g.adapter) == (
            w.t, w.model, w.prompt, w.max_new_tokens, w.adapter)
    values = [a.t for a in got][::3]
    assert driver.percentiles(values) == ref_driver.percentiles(values)
    assert driver.percentiles([]) == ref_driver.percentiles([])


def _close(got, want, path="report"):
    """Same keys, equal strings and bools, numbers within NUM_TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for key in want:
            _close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    else:
        assert abs(got - want) <= NUM_TOL, (path, got, want)


@pytest.fixture(scope="module")
def bench_args():
    return argparse.Namespace(seed=0, duration=8.0, rate=3.0,
                              slo=list(ref_bench.DEFAULT_SLOS), device="cpu",
                              card=False, checkpoint="")


def test_bench_serve_report_equals_reference(bench_args):
    assert bench_serve.DEFAULT_SLOS == ref_bench.DEFAULT_SLOS
    want = ref_bench.run(bench_args)
    # the reference's own weights, bridged (no eos: the schedule does not
    # depend on them, but the engines run the same model)
    tc = tl.tiny_config()
    params = params_from_numpy(
        jax.tree.map(np.asarray, jl.init_llama_params(jax.random.key(0), jl.tiny_config())),
        tc, device="cpu")
    got = bench_serve.run(bench_args, params=params, model_config=tc)
    wall = got.pop("wall")
    assert wall["drive_s"] > 0 and wall["device"] == "cpu"
    assert want["aggregate"]["requests"] >= 15
    assert want["models"]["hot"]["tokens"] > want["models"]["cold"]["tokens"] > 0
    _close(got, want)


def test_bench_serve_main_runs_the_tiny_model_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    report = bench_serve.main(["--device", "cpu", "--duration", "4", "--rate", "2",
                               "--slo", "p95 ttft < 1s", "--output", str(out)])
    assert out.read_text().startswith("{")
    assert list(report["slo"]["verdicts"]) == ["ttft_p95_lt_1s"]
    assert report["aggregate"]["requests"] == len(driver.build_arrivals(
        bench_serve.workload(bench_serve.parse_args(["--duration", "4", "--rate", "2"]))))
    smoke = bench_serve.parse_args(["--smoke", "--duration", "60", "--rate", "9"])
    assert (smoke.duration, smoke.rate) == (20.0, 3.0)


def test_card_mode_refuses_the_cpu():
    args = bench_serve.parse_args(["--card", "--device", "cpu", "--duration", "1"])
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench_serve.run(args)
    params = tl.init_llama_params(tl.tiny_config(), 0, device="cpu")
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench_serve.calibrate(params, tl.tiny_config())


def test_driver_refuses_a_wall_clock_and_traces_each_drive():
    cfg = tl.tiny_config()
    params = tl.init_llama_params(cfg, 0, device="cpu")
    config = driver.WorkloadConfig(seed=1, duration_s=2.0, rate_rps=2.0)
    wall = Engine(params, cfg, max_slots=2, max_len=128, telemetry=ServeTelemetry())
    with pytest.raises(ValueError, match="VirtualServeClock"):
        driver.OpenLoopDriver({"default": wall}, config)
    with pytest.raises(ValueError, match="no engine"):
        driver.OpenLoopDriver({}, config)
    slo = engine.SLOEngine(["p95 ttft < 400ms", "availability 99%"])
    engines = bench_serve.build_engines(config, slo, params, cfg)
    report = driver.OpenLoopDriver(engines, config, slo=slo).run()
    assert report["aggregate"]["requests"] == len(driver.build_arrivals(config))
    drives = [t.root for t in TRACER.store.list() if t.root.name == "serve.drive"]
    assert drives and drives[0].attributes == {
        "model": "default", "arrivals": report["aggregate"]["requests"]}
    text = REGISTRY.render()
    for name in ("nos_tpu_slo_burn_rate", "nos_tpu_slo_compliant",
                 "nos_tpu_slo_error_budget_remaining"):
        assert name in text
    payload = slo.debug_payload()
    assert payload["requests_seen"] == report["aggregate"]["requests"]
    assert {s["slo"] for s in payload["slos"]} == {"ttft_p95_lt_400ms", "availability_99"}


def test_slo_engine_matches_reference_on_the_same_records():
    """The same retired records give the reference's evaluation."""
    from nos_tpu.serve import telemetry as ref_tel
    from nos_tpu_torch.serve import telemetry as tel

    specs = ["p95 ttft < 300ms", "p50 tpot < 20ms", "p99 e2e < 2s", "availability 99%"]
    rng = np.random.default_rng(5)
    ours = engine.SLOEngine(specs, fast_window_s=5.0, slow_window_s=50.0)
    theirs = ref_engine.SLOEngine(specs, fast_window_s=5.0, slow_window_s=50.0)
    for i in range(60):
        submit = float(i) * 0.5
        first = submit + float(rng.uniform(0.05, 0.6))
        retire = first + float(rng.uniform(0.0, 2.0))
        fields = dict(id=i, model="m", adapter=0, bucket=16, prompt_tokens=8,
                      max_new_tokens=16, submit_t=submit, admit_t=submit + 0.01,
                      first_token_t=first, retire_t=retire,
                      tokens=int(rng.integers(1, 40)), good=bool(rng.random() < 0.97),
                      trace_id=f"t{i}")
        ours.record(tel.RequestRecord(**fields))
        theirs.record(ref_tel.RequestRecord(**fields))
    assert ours.latency_targets() == theirs.latency_targets()
    assert ours.evaluate(now=31.0) == theirs.evaluate(now=31.0)
    assert ours.debug_payload()["recent_violations"] == theirs.debug_payload()["recent_violations"]
