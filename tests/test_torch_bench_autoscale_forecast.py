"""The autoscaler and forecaster benches (nos_tpu_torch.bench_autoscale,
nos_tpu_torch.bench_forecast) against the reference's bench_autoscale.py
and bench_forecast.py.

Each reference bench runs once for the module, in a child process (its
cluster's threads and process-wide metrics stay out of this worker):
``run_bench(seed=0, duration_s=80.0, rate_rps=14.0)`` and
``run_bench()`` (seed 5). Under the translation (one v5e 2x4 board is
one H100; a replica's ``2x4`` is a ``7g.80gb`` of 8 memory slices; one
chip is 10 GB, so chip-seconds x 10 are GB-seconds; the forecast's 2x2
/ 1x2 are 4g.40gb / 2g.20gb) every key of the reference's reports must
equal the port's, but the forecaster's ``replay``, which waits for the
flight recorder. Two port runs give the same bytes on every virtual key.
"""
import json
import os
import subprocess
import sys

import pytest

from nos_tpu_torch import bench_autoscale as ba
from nos_tpu_torch import bench_forecast as bf
from tests.torch_planner_cases import TO_MIG, to_port_resource

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = """
import json, sys
import bench_autoscale, bench_forecast
autoscale = bench_autoscale.run_bench(seed=0, duration_s=80.0, rate_rps=14.0)
forecast, _ = bench_forecast.run_bench()
json.dump({"autoscale": autoscale, "forecast": forecast}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "reports.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", REFERENCE, str(out)], cwd=ROOT, env=env,
                   check=True, timeout=300)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def autoscale_runs():
    sizes = ba.AutoscaleSizes.reference()
    return ba.run_bench(sizes, duration_s=80.0), ba.run_bench(sizes, duration_s=80.0)


def translate(value):
    if isinstance(value, dict):
        return {(TO_MIG.get(k, to_port_resource(k)) if isinstance(k, str) else k):
                translate(v) for k, v in value.items()}
    if isinstance(value, list):
        return [translate(v) for v in value]
    return value


def test_autoscale_equals_the_reference_under_the_translation(reference, autoscale_runs):
    want = dict(reference["autoscale"])
    for serving in want["servings"].values():
        serving["slice_profile"] = TO_MIG[serving["slice_profile"]]
    chips = want.pop("capacity")
    want["capacity"] = {
        "total_gb_seconds": 10 * chips["total_chip_seconds"],
        "busy_gb_seconds": 10 * chips["busy_chip_seconds"],
        "idle_gb_seconds": {b: 10 * v for b, v in chips["idle_chip_seconds"].items()}}
    got = autoscale_runs[0]
    assert {k: got[k] for k in want} == want
    # the port's own keys beside them
    assert got["invariants_hold"] and all(got["invariants"].values())
    assert got["grace"]["scaled_to_zero"] == ["batch"] and got["grace"]["vacated_nodes_held"]
    assert got["capacity"]["idle_gb_seconds"]["autoscaler-grace"] > 0


def test_two_autoscale_runs_give_the_same_bytes(autoscale_runs):
    first, second = autoscale_runs
    assert ba.virtual_digest(first) == ba.virtual_digest(second) == ba.REFERENCE_80S_DIGEST
    body = {k: v for k, v in first.items() if k != "wall_s"}
    assert json.dumps(body, sort_keys=True) == json.dumps(
        {k: v for k, v in second.items() if k != "wall_s"}, sort_keys=True)


def test_forecast_equals_the_reference_less_replay(reference):
    want = translate({k: v for k, v in reference["forecast"].items() if k != "replay"})
    got = bf.run_bench()
    assert json.loads(json.dumps({k: got[k] for k in want}, sort_keys=True)) == json.loads(
        json.dumps(want, sort_keys=True))
    assert bf.failures(got) == []
    assert got["stages"] == bf.REFERENCE_STAGES
    assert got["accuracy"]["p95_ratio"] <= bf.ACCURACY_TARGET_P95_RATIO
    assert got["overhead"]["forecast_store_writes"] == 0
    assert bf.virtual_digest(got) == bf.virtual_digest(bf.run_bench())


def test_forecast_bench_restores_the_geometry_table():
    from nos_tpu_torch.gpu.known import known_geometry_overrides

    before = known_geometry_overrides()
    bf.run_bench()
    assert known_geometry_overrides() == before


def test_sizes_and_the_card_run_of_both_cli():
    quick, card = ba.AutoscaleSizes.quick(), ba.AutoscaleSizes.card()
    assert quick.nodes * quick.gpus_per_node == 64 == quick.pairs * 4
    assert (card.nodes * card.gpus_per_node, card.pools, card.pairs) == (256, 4, 64)
    roles = bf.ForecastSizes.card().node_roles()
    assert len(roles) == 32 and sorted(set(roles.values())) == ["gang", "mixed", "spare"]
    assert bf.ForecastSizes.reference().node_roles() == {
        "w0": "gang", "w1": "gang", "w3": "mixed", "spare0": "spare"}
    assert ba.model_names(2) == [("chat-0", "batch-0"), ("chat-1", "batch-1")]
