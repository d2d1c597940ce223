"""The store and observability benches (nos_tpu_torch.bench_store,
nos_tpu_torch.bench_observability) against the reference's
bench_store.py and bench_observability.py at 100 nodes x 1,000 pods.

The reference's benches run once for the module in a child process (its
registries stay out of this worker): ``bench_store.run_config(100, 1000,
8, quick=True)`` and ``bench_observability.run_config(100, 1000, 2)``.
Under the translation (a node's 8 H100s for a v5e board's 8 chips, a pod
holding one ``nvidia.com/gpu`` for one ``google.com/tpu``):

- every store row's keys that are functions of the configuration (bench,
  sizes, ``copy``, ``variant``, ``lookups``, ``patches``, ``watchers``,
  ``writes``, ``events_delivered``, ``events``) are equal; the port's
  rows add medians and means beside the reference's rates;
- the observability row is equal key for key, the governed exposition's
  sha256 included (the synthetic capacity families keep the reference's
  names and help, and the accounting the same numbers), and each
  ``*_within_budget`` holds on the port's side.

Two port runs give the same deterministic fields.
"""
import json
import os
import subprocess
import sys

import pytest

from nos_tpu_torch import bench_observability as bo
from nos_tpu_torch import bench_store as bs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = """
import json, sys
import bench_observability, bench_store
store = bench_store.run_config(100, 1000, 8, True)
row, timing = bench_observability.run_config(100, 1000, 2)
json.dump({"store": store, "obs": row, "timing": timing}, open(sys.argv[1], "w"))
"""
# the reference's timed keys of its store rows
REF_TIMING = {"seed_seconds", "creates_per_sec", "p50_ms", "lists_per_sec", "p50_lookup_ms",
              "lookups_per_sec", "patches_per_sec", "events_per_sec"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "benches.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", REFERENCE, str(out)], cwd=ROOT, env=env,
                   check=True, timeout=300, capture_output=True)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_runs():
    return [(bs.run_config(100, 1000, 8, True), bo.run_config(100, 1000, 2))
            for _ in range(2)]


def test_the_store_rows_equal_the_references(reference, port_runs):
    ours = port_runs[0][0]
    theirs = reference["store"]
    assert [r["bench"] for r in ours] == [r["bench"] for r in theirs]
    for got, want in zip(ours, theirs):
        assert bs.deterministic(got) == {k: v for k, v in want.items() if k not in REF_TIMING}
        assert set(want) <= set(got)
        assert set(got) - set(want) <= bs.TIMING_KEYS
    fanout = next(r for r in ours if r["bench"] == "store_watch_fanout")
    assert fanout["events_delivered"] == 8 * 200


def test_the_observability_row_equals_the_references(reference, port_runs):
    row, timing = port_runs[0][1]
    want = reference["obs"]
    assert {k: v for k, v in row.items() if k != "overhead"} == \
        {k: v for k, v in want.items() if k != "overhead"}
    assert set(row["overhead"]) == set(want["overhead"])
    assert row["exposition"]["governed_sha256"] == want["exposition"]["governed_sha256"]
    assert row["exposition"]["byte_identical"]
    assert all(v for k, v in row["overhead"].items() if k.endswith("_within_budget"))
    assert set(timing) == set(reference["timing"])


def test_two_port_runs_give_the_same_fields(port_runs):
    (store_a, (obs_a, _)), (store_b, (obs_b, _)) = port_runs
    assert [bs.deterministic(r) for r in store_a] == [bs.deterministic(r) for r in store_b]
    assert {k: v for k, v in obs_a.items() if k != "overhead"} == \
        {k: v for k, v in obs_b.items() if k != "overhead"}


def test_the_governor_folds_past_the_node_budget(monkeypatch):
    """Past ``NODE_BUDGET`` node series the governed exposition folds into
    one ``_other`` child of the family's label keys, deterministically."""
    monkeypatch.setattr(bo, "NODE_BUDGET", 30)
    store = bs.seed_store(20, 100)
    fleet, pending = bo.fleet_from_store(store)
    a = bo.governed_registry(fleet, pending)
    b = bo.governed_registry(fleet, pending)
    report = a.series_report()[bo.NODE_FAMILY]
    assert report == {"exact": 30, "overflow": 1, "dropped": 30, "budget": 30}
    assert a.render() == b.render()
    assert 'nos_tpu_capacity_node_chips{node="_other",state="_other"}' in a.render()


def test_the_sizes():
    assert bs.StoreSizes.reference().configs == ((1000, 10000),)
    assert bs.StoreSizes.quick() == bs.StoreSizes(configs=((100, 1000),), short=True)
    assert bs.StoreSizes.card().configs == ((10000, 100000), (100000, 1000000))
    assert bo.ObservabilitySizes.reference().configs == ((1000, 10000),)
    assert bo.ObservabilitySizes.card().configs == ((1000, 10000), (100000, 1000000))
    assert bo.ObservabilitySizes.quick().repeats == 2


def test_the_seeded_store_is_the_references_shape():
    store = bs.seed_store(10, 100)
    pods = store.list("Pod", copy=False)
    assert sum(1 for p in pods if not p.node) == 10
    assert all(p.request == {"nvidia.com/gpu": 1} for p in pods)
    assert len(store.list_by_index("Pod", "spec.nodeName", "node-00003")) == 10
    assert store.list_by_index("Pod", "spec.nodeName", "node-00000") == []  # every tenth pends
    assert len(store.list_by_index("Pod", "status.phase", "Pending")) == 10
    node = store.get("Node", "node-00000")
    assert node.allocatable["nvidia.com/gpu"] == 8
