"""The installation telemetry snapshot: counterpart of
``nos_tpu/cmd/metricsexporter.py:26-111`` (reference
cmd/metricsexporter/metricsexporter.go:33-91, the schema of
metrics/metrics.go:8-33), in H100 terms.

``collect_metrics`` counts the nodes, the GPU nodes and their GPUs
(``nvidia.com/gpu`` capacity), the partitioning modes in use (MIG, MPS)
and the quotas, with the metrics registry's snapshot. ``export`` writes
it to a file (the running suite keeps one, ``cmd/run.py``); it is POSTed
(``_post``) only when an endpoint is given: nothing leaves the host by
default. ``main`` is the one-shot job: read the suite's snapshot,
validate it, print it, and forward it when asked.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List

from nos_tpu_torch.gpu.node import PARTITIONING_LABEL, RESOURCE_GPU
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.util.metrics import REGISTRY

VERSION = "0.1.0"
DEFAULT_SNAPSHOT_PATH = "nos-tpu-torch-metrics.json"


@dataclass
class InstallationMetrics:
    """The reference's schema, GPUs where it counts TPU chips."""

    version: str = VERSION
    timestamp: float = 0.0
    node_count: int = 0
    gpu_node_count: int = 0
    partitioning_modes: List[str] = field(default_factory=list)
    total_gpus: int = 0
    elastic_quota_count: int = 0
    composite_elastic_quota_count: int = 0
    domain_metrics: Dict[str, float] = field(default_factory=dict)


def collect_metrics(store: NodeStore) -> InstallationMetrics:
    m = InstallationMetrics(timestamp=time.time())
    modes = set()
    for node in store.list("Node", copy=False):
        m.node_count += 1
        mode = node.labels.get(PARTITIONING_LABEL)
        if mode:
            modes.add(mode)
        gpus = int(node.capacity.get(RESOURCE_GPU, 0))
        if gpus:
            m.gpu_node_count += 1
            m.total_gpus += gpus
    m.partitioning_modes = sorted(modes)
    m.elastic_quota_count = len(store.list("ElasticQuota", copy=False))
    m.composite_elastic_quota_count = len(store.list("CompositeElasticQuota", copy=False))
    m.domain_metrics = REGISTRY.snapshot()
    return m


def _post(payload: str, endpoint: str) -> None:
    import urllib.request

    request = urllib.request.Request(endpoint, data=payload.encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=10):  # opt-in only
        pass


def export(metrics: InstallationMetrics, output_path: str = "", endpoint: str = "") -> str:
    payload = json.dumps(asdict(metrics), indent=2)
    if output_path:
        with open(output_path, "w") as f:
            f.write(payload + "\n")
    if endpoint:
        _post(payload, endpoint)
    return payload


def main(argv=None) -> int:
    """``python -m nos_tpu_torch export-metrics``: forward the suite's snapshot."""
    parser = argparse.ArgumentParser(prog="python -m nos_tpu_torch export-metrics",
                                     description="the installation telemetry exporter")
    parser.add_argument("--input", default=DEFAULT_SNAPSHOT_PATH,
                        help="the snapshot file the running suite writes")
    parser.add_argument("--endpoint", default="",
                        help="where to POST it (nothing is sent when empty)")
    args = parser.parse_args(argv)
    try:
        with open(args.input) as f:
            payload = f.read()
    except FileNotFoundError:
        print(f"no metrics snapshot at {args.input}; is the suite running with "
              "manager.metricsSnapshotPath set?", file=sys.stderr)
        return 1
    json.loads(payload)  # valid before it is forwarded
    if args.endpoint:
        _post(payload, args.endpoint)
    print(payload)
    return 0
