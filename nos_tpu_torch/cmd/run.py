"""``python -m nos_tpu_torch run --config <file>``: the whole suite in one
process.

Counterpart of ``nos_tpu/cmd/run.py:39-413``: the config's sections
decode into the typed configs (``configs_from``), ``nodes:``, ``pods:``
and ``modelServings:`` are seeded (``seed_node``, ``seed_pod``,
``seed_modelserving``, in H100 terms), and every component runs threaded
on one store (``cmd/cluster.py``), with the health server and, where
``manager.metricsSnapshotPath`` is set, the installation snapshot
rewritten every ``metricsSnapshotSeconds`` (60) for ``export-metrics``.
``--run-seconds`` ends the run after that many seconds; SIGINT and
SIGTERM end it otherwise. The config's ``observability:`` section
(``observability_from``: ``seriesBudget``, ``traceTailCapacity``,
``traceBoringSampleN``, ``traceSlowThresholds``, ``debugPageLimit``;
``nodeTopK`` above 0 is refused, item 18b.3) is applied to the process's
registry and tracer before any component registers a series, and put
back on the way out; the suite runs a health timeline
(``manager.timelineSampleSeconds``) and the stack profiler, and serves
their ``/debug/`` endpoints. ``--record <path>`` runs the flight
recorder (the reference's ``:273-311``): attached to the store before
the seeding (the nodes' and pods' creation is replay's input), fed by
every component and by the timeline's findings, served at
``/debug/record``, and written to ``<path>`` as JSONL on the way out,
for ``python -m nos_tpu_torch replay``. ``partitioner.auditSampleRate``
runs the invariant auditor on that share of the plans.

The config keys, where they differ from the reference's:

- ``partitioner``: ``knownMigGeometries`` (for ``knownTpuGeometries``),
  ``agingPerSecond`` (for ``agingChipsPerSecond``), ``forecastEnabled``
  (refused: item 18b.3);
- ``operator``: ``gpuMemoryGB`` (80; for the top-level
  ``tpuChipMemoryGB``);
- a node: ``name``, ``gpus`` (8), ``product`` (an H100 80GB),
  ``partitioning`` (``mig`` or ``mps``; hybrid nodes are not supported),
  ``nodepool``;
- a pod: ``name``, ``namespace``, one of ``mig: <profile>``,
  ``mps: <N>gb`` or ``gpus: <N>`` (with ``count``, 1), ``gang`` and
  ``gangSize``, ``nodepool``, ``priority``, ``schedulerName``;
- a ModelServing: ``sliceProfile`` a MIG profile (``7g.80gb``).
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from typing import Callable, NamedTuple, Optional

from nos_tpu_torch.api.config import (
    AgentConfig,
    AutoscalerConfig,
    GpuPartitionerConfig,
    ObservabilityConfig,
    OperatorConfig,
    SchedulerConfig,
)
from nos_tpu_torch.api.config.v1alpha1 import DEVICE_PLUGIN_CONFIG_MAP, H100_MEMORY_GB
from nos_tpu_torch.api.v1alpha1.constants import SCHEDULER_NAME
from nos_tpu_torch.cluster import HOSTNAME_LABEL, NODE_CPU, NODE_MEMORY_GIB
from nos_tpu_torch.cmd._component import load_config
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import (
    PARTITIONING_LABEL,
    PARTITIONING_MIG,
    PARTITIONING_MPS,
    RESOURCE_GPU,
    mig_resource,
    mps_resource,
)
from nos_tpu_torch.kube.store import Node, Pod
from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL

log = logging.getLogger("nos_tpu_torch.cmd")

__all__ = ["Configs", "configs_from", "load_config", "main", "observability_from", "seed",
           "seed_modelserving", "seed_node", "seed_pod"]


class Configs(NamedTuple):
    partitioner: GpuPartitionerConfig
    scheduler: SchedulerConfig
    agent: AgentConfig
    autoscaler: Optional[AutoscalerConfig]
    operator: OperatorConfig


def configs_from(config: dict) -> Configs:
    """The typed, validated configs of a config document (a section with
    no keys reads as absent; the autoscaler's only when present)."""
    p = config.get("partitioner") or {}
    s = config.get("scheduler") or {}
    a = config.get("agent") or {}
    o = config.get("operator") or {}
    partitioner = GpuPartitionerConfig(
        batch_window_timeout_seconds=p.get("batchWindowTimeoutSeconds", 60.0),
        batch_window_idle_seconds=p.get("batchWindowIdleSeconds", 10.0),
        known_mig_geometries=p.get("knownMigGeometries"),
        device_plugin_config_map=p.get("devicePluginConfigMap", DEVICE_PLUGIN_CONFIG_MAP),
        scheduler_config_file=p.get("schedulerConfigFile", ""),
        aging_per_second=p.get("agingPerSecond", 1.0),
        scheduler_name=p.get("schedulerName", SCHEDULER_NAME),
        audit_sample_rate=p.get("auditSampleRate", 0.0),
        incremental_planning=p.get("incrementalPlanning", True),
        incremental_dirty_threshold=p.get("incrementalDirtyThreshold", 0.25),
        pool_sharding=p.get("poolSharding", False),
        pool_parallelism=p.get("poolParallelism", "serial"),
        pool_max_workers=p.get("poolMaxWorkers", 0),
        pool_backend=p.get("poolBackend", ""),
        pool_cycle_timeout_seconds=p.get("poolCycleTimeoutSeconds", 5.0),
        warm_state_path=p.get("warmStatePath", ""),
        warm_state_save_interval_seconds=p.get("warmStateSaveIntervalSeconds", 30.0),
        forecast_enabled=p.get("forecastEnabled", False))
    scheduler = SchedulerConfig(
        retry_seconds=s.get("retrySeconds", 0.5),
        gang_wait_timeout_seconds=s.get("gangWaitTimeoutSeconds", 30.0),
        scheduler_name=s.get("schedulerName", SCHEDULER_NAME))
    agent = AgentConfig(report_config_interval_seconds=a.get("reportConfigIntervalSeconds",
                                                             10.0))
    operator = OperatorConfig(gpu_memory_gb=int(o.get("gpuMemoryGB", H100_MEMORY_GB)))
    autoscaler = None
    if "autoscaler" in config:
        u = config.get("autoscaler") or {}
        autoscaler = AutoscalerConfig(
            scale_up_burn_threshold=u.get("scaleUpBurnThreshold", 1.0),
            scale_down_burn_threshold=u.get("scaleDownBurnThreshold", 0.5),
            scale_down_stable_seconds=u.get("scaleDownStableSeconds", 120.0),
            recent_activity_seconds=u.get("recentActivitySeconds", 30.0),
            resync_seconds=u.get("resyncSeconds", 5.0))
    for c in (partitioner, scheduler, agent, autoscaler, operator):
        if c is not None:
            c.validate()
    return Configs(partitioner, scheduler, agent, autoscaler, operator)


def observability_from(config: dict) -> ObservabilityConfig:
    """The validated ``observability:`` section (``nos_tpu/cmd/run.py:
    103-130``); none leaves every knob off. ``seriesBudget.default`` is
    the other families' budget, every other key names a family."""
    o = config.get("observability") or {}
    budgets = dict(o.get("seriesBudget") or {})
    default = budgets.pop("default", o.get("seriesBudgetDefault"))
    obs = ObservabilityConfig(
        series_budget={str(k): int(v) for k, v in budgets.items()},
        series_budget_default=int(default) if default is not None else None,
        node_top_k=int(o.get("nodeTopK", 0)),
        trace_tail_capacity=int(o.get("traceTailCapacity", 64)),
        trace_boring_sample_n=int(o.get("traceBoringSampleN", 1)),
        trace_slow_thresholds={str(k): float(v)
                               for k, v in (o.get("traceSlowThresholds") or {}).items()},
        debug_page_limit=int(o.get("debugPageLimit", 500)))
    obs.validate()
    return obs


def seed_node(spec: dict) -> Node:
    """A node of ``gpus`` H100s (8) in MIG or MPS mode."""
    kind = spec.get("partitioning", PARTITIONING_MIG)
    if kind not in (PARTITIONING_MIG, PARTITIONING_MPS):
        raise ValueError(f"node {spec.get('name')}: partitioning {kind!r} is not supported "
                         f"(only {PARTITIONING_MIG!r} and {PARTITIONING_MPS!r})")
    name = spec["name"]
    resources = {RESOURCE_GPU: int(spec.get("gpus", 8)), "cpu": int(spec.get("cpu", NODE_CPU)),
                 "memory": int(spec.get("memoryGiB", NODE_MEMORY_GIB))}
    labels = {GPU_PRODUCT_LABEL: spec.get("product", H100_80GB), PARTITIONING_LABEL: kind,
              HOSTNAME_LABEL: name}
    if "nodepool" in spec:
        labels[NODEPOOL_LABEL] = str(spec["nodepool"])
    return Node(name, labels=labels, capacity=dict(resources), allocatable=dict(resources))


def seed_pod(spec: dict) -> Pod:
    """A pending pod of a ``pods:`` entry: ``count`` (1) of one MIG
    profile (``mig``), one MPS slice (``mps``) or ``gpus`` whole GPUs."""
    count = int(spec.get("count", 1))
    if "mig" in spec:
        request = {mig_resource(str(spec["mig"])): count}
    elif "mps" in spec:
        request = {mps_resource(str(spec["mps"])): count}
    else:
        request = {RESOURCE_GPU: int(spec.get("gpus", 1))}
    labels = {}
    if "gang" in spec:
        from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL

        labels[GANG_NAME_LABEL] = str(spec["gang"])
        labels[GANG_SIZE_LABEL] = str(spec.get("gangSize", 1))
    node_selector = {NODEPOOL_LABEL: str(spec["nodepool"])} if "nodepool" in spec else {}
    return Pod(spec["name"], spec.get("namespace", "default"), request=request, labels=labels,
               node_selector=node_selector, priority=int(spec.get("priority", 0)),
               scheduler_name=spec.get("schedulerName", SCHEDULER_NAME))


def seed_modelserving(spec: dict):
    """A ModelServing of a ``modelServings:`` entry."""
    from nos_tpu_torch.api.v1alpha1.modelserving import ModelServing, ModelServingSpec

    ms = ModelServing(spec["name"], spec.get("namespace", "default"), spec=ModelServingSpec(
        model=spec.get("model", spec["name"]), slice_profile=spec.get("sliceProfile", "7g.80gb"),
        min_replicas=int(spec.get("minReplicas", 0)), max_replicas=int(spec.get("maxReplicas", 1)),
        slos=list(spec.get("slos", [])),
        scale_to_zero_idle_seconds=spec.get("scaleToZeroIdleSeconds", 300.0),
        cold_start_grace_seconds=spec.get("coldStartGraceSeconds", 60.0),
        target_queue_depth=int(spec.get("targetQueueDepth", 4)),
        scale_down_budget_surplus=spec.get("scaleDownBudgetSurplus", 0.5),
        scheduler_name=spec.get("schedulerName", SCHEDULER_NAME)))
    ms.spec.validate()
    return ms


def seed(cluster, config: dict, agent: Optional[AgentConfig] = None) -> None:
    """The config's nodes (with their agents), pods and ModelServings."""
    for spec in config.get("nodes") or []:
        cluster.add_node(seed_node(spec), agent)
    for spec in config.get("pods") or []:
        cluster.store.create(seed_pod(spec))
    for spec in config.get("modelServings") or []:
        cluster.store.create(seed_modelserving(spec))


def main(argv=None, stop_event: Optional[threading.Event] = None,
         on_started: Optional[Callable[[dict], None]] = None) -> int:
    """Run the suite; 0. ``on_started`` gets {"health_port", "cluster",
    "timeline", "flight"} once it runs (in-process callers)."""
    from nos_tpu_torch.cmd._component import build_timeline, health_server
    from nos_tpu_torch.cmd.cluster import build_cluster
    from nos_tpu_torch.obsplane.apply import apply_observability
    from nos_tpu_torch.util.profiling import PROFILER

    parser = argparse.ArgumentParser(prog="python -m nos_tpu_torch run",
                                     description="run the whole suite in one process")
    parser.add_argument("--config", default="", help="the suite config (JSON or YAML)")
    parser.add_argument("--health-port", type=int, default=None)
    parser.add_argument("--run-seconds", type=float, default=None,
                        help="stop after this many seconds instead of at a signal")
    parser.add_argument("--record", default="",
                        help="write the flight recorder's log here (JSONL) on exit")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    stop = stop_event or threading.Event()
    if stop_event is None:
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    config = load_config(args.config)
    configs = configs_from(config)
    obs = observability_from(config)
    if config.get("deviceBackend", "sim") != "sim":
        raise ValueError("the in-process suite runs on the sim devices (deviceBackend: sim)")
    # before any component registers a series: the exact / _other split
    # follows the order of admission
    revert_observability = apply_observability(obs)
    cluster = health = timeline = flight = None
    snapshot_thread = None
    try:
        if args.record:
            from nos_tpu_torch.record import FlightRecorder

            flight = FlightRecorder()
        cluster = build_cluster(partitioner_config=configs.partitioner,
                                scheduler_config=configs.scheduler,
                                operator_config=configs.operator,
                                autoscaler_config=configs.autoscaler, flight_recorder=flight)
        if flight is not None:
            # before the seeding: the creations are replay's input
            flight.attach(cluster.store)
        seed(cluster, config, configs.agent)
        timeline = build_timeline(config, cluster.store, "nos-health-timeline", flight=flight)
        health = health_server(config, args.health_port, cluster.scheduler, cluster.store,
                               timeline, record_fn=flight.records if flight else None)
        health.autoscaler_fn = cluster.autoscaler.debug_payload if cluster.autoscaler else None
        health.debug_page_limit = obs.debug_page_limit
        port = health.start()
        log.info("health and metrics on port %d (/healthz /readyz /metrics /debug/)", port)
        PROFILER.start()
        cluster.start()
        timeline.start()
        manager_cfg = config.get("manager") or {}
        snapshot_path = manager_cfg.get("metricsSnapshotPath", "")
        if snapshot_path:
            from nos_tpu_torch.cmd.metricsexporter import collect_metrics, export

            interval = float(manager_cfg.get("metricsSnapshotSeconds", 60))

            def snapshot_loop() -> None:
                while not stop.is_set():
                    try:
                        export(collect_metrics(cluster.store), snapshot_path)
                    except OSError:
                        log.exception("the metrics snapshot could not be written")
                    stop.wait(interval)

            snapshot_thread = threading.Thread(target=snapshot_loop, name="metrics-snapshot",
                                               daemon=True)
            snapshot_thread.start()
        log.info("the suite is running")
        if on_started is not None:
            on_started({"health_port": port, "cluster": cluster, "timeline": timeline,
                        "flight": flight})
        stop.wait(args.run_seconds)
    finally:
        stop.set()
        if snapshot_thread is not None:
            snapshot_thread.join(timeout=5.0)
        if timeline is not None:
            timeline.stop()
        if cluster is not None:
            cluster.stop()
        PROFILER.stop()
        if health is not None:
            health.stop()
        if timeline is not None:
            timeline.close()
        revert_observability()
        if flight is not None:
            flight.detach()
            count = flight.export_jsonl(args.record)
            log.info("flight record: %d record(s) -> %s", count, args.record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
