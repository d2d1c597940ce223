"""The components' configs against the reference's.

- ``configs_from`` on the reference's ``examples/suite.yaml`` and on the
  port's ``nos_tpu_torch/examples/suite.yaml``, and on one document of
  every partitioner, scheduler, agent and autoscaler key, agree field by
  field under the translation: ``knownTpuGeometries`` /
  ``agingChipsPerSecond`` / ``TpuAgentConfig`` are
  ``knownMigGeometries`` / ``agingPerSecond`` / ``AgentConfig``, the
  operator's 16 GB chip is an 80 GB H100, and the forecaster is off
  (refused until item 18b, where the reference's runs by default).
- Each ``validate()`` raises on the same bad values, with the same
  message under the field names' translation (parametrised).
- The port refuses what it does not run, the forecaster's thread (item
  18b.3); the auditor's rate is accepted since item 18b.2.
- Config documents and kubeconfigs are read JSON-first: with ``yaml``
  blocked from ``sys.modules`` a JSON config and a JSON kubeconfig load,
  and a component runs from them against the stub API server; a YAML
  document then fails with a clear error.
"""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import pytest

from nos_tpu.api.config import v1alpha1 as jcfg
from nos_tpu.cmd import run as jrun
from nos_tpu_torch.api.config import v1alpha1 as tcfg
from nos_tpu_torch.cmd import run as trun

ROOT = Path(__file__).resolve().parents[1]

# the port's field name for each reference field whose name changed
FIELD_NAMES = {"aging_chips_per_second": "aging_per_second",
               "known_tpu_geometries": "known_mig_geometries",
               "tpu_chip_memory_gb": "gpu_memory_gb"}
# reference fields with no port counterpart
NOT_PORTED = {"device_plugin_delay_seconds"}
# fields whose values differ under the translation, and why
TRANSLATED = {"forecast_enabled": (True, False)}  # refused until item 18b


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_same_fields(ref, port):
    want = {FIELD_NAMES.get(k, k): v for k, v in _fields(ref).items() if k not in NOT_PORTED}
    got = _fields(port)
    assert set(want) == set(got), (set(want) ^ set(got))
    for name, value in want.items():
        if name == "manager":
            assert _fields(value) == _fields(got[name])
        elif name in TRANSLATED:
            assert (value, got[name]) == TRANSLATED[name], name
        else:
            assert got[name] == value, name


def _load_yaml(path):
    import yaml

    return yaml.safe_load(Path(path).read_text())


def test_the_suites_decode_to_the_same_configs():
    ref = jrun.configs_from(_load_yaml(ROOT / "examples" / "suite.yaml"))
    port = trun.configs_from(trun.load_config(str(ROOT / "nos_tpu_torch/examples/suite.yaml")))
    for r, p in zip(ref, port):
        if r is None:
            assert p is None
        else:
            assert_same_fields(r, p)
    # the operator reads its chip's GB at the top level in the reference
    assert port.operator.gpu_memory_gb == 80 and jcfg.OperatorConfig().tpu_chip_memory_gb == 16


FULL = {
    "batchWindowTimeoutSeconds": 7.5, "batchWindowIdleSeconds": 1.5,
    "devicePluginConfigMap": "plugin-cm", "schedulerConfigFile": "sched.yaml",
    "schedulerName": "other-scheduler", "auditSampleRate": 0.0,
    "incrementalPlanning": True, "incrementalDirtyThreshold": 0.5, "poolSharding": True,
    "poolParallelism": "thread", "poolMaxWorkers": 3, "poolBackend": "process",
    "poolCycleTimeoutSeconds": 2.5, "warmStatePath": "warm", "warmStateSaveIntervalSeconds": 9,
}


def test_every_key_decodes_to_the_same_configs():
    ref_doc = {"partitioner": dict(FULL, agingChipsPerSecond=0.25),
               "scheduler": {"retrySeconds": 0.2, "gangWaitTimeoutSeconds": 4,
                             "schedulerName": "x"},
               "agent": {"reportConfigIntervalSeconds": 3},
               "autoscaler": {"scaleUpBurnThreshold": 2.0, "scaleDownBurnThreshold": 0.25,
                              "scaleDownStableSeconds": 9, "recentActivitySeconds": 4,
                              "resyncSeconds": 1.5}}
    port_doc = dict(ref_doc, partitioner=dict(FULL, agingPerSecond=0.25))
    for r, p in zip(jrun.configs_from(ref_doc), trun.configs_from(port_doc)):
        assert_same_fields(r, p)


def _ref_autoscaler(**kw):
    return jcfg.AutoscalerConfig(**kw)


# (reference config, port config, field, bad value, extra fields both get)
BAD_VALUES = [
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "aging_chips_per_second", -1.0, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "audit_sample_rate", 1.5, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "audit_sample_rate", -0.1, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "incremental_dirty_threshold", 0.0,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "incremental_dirty_threshold", 1.5,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "batch_window_timeout_seconds", 0.0,
     {"batch_window_idle_seconds": 0.0}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "batch_window_idle_seconds", -1.0,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "batch_window_idle_seconds", 61.0,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_sharding", True,
     {"incremental_planning": False}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_parallelism", "fork", {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_max_workers", -1, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_backend", "gpu", {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_backend", "process", {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "pool_cycle_timeout_seconds", 0.0,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "warm_state_save_interval_seconds",
     -1.0, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "forecast_min_interval_seconds",
     -1.0, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "forecast_max_gangs", 0, {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "forecast_max_backfill_pairs", -1,
     {}),
    (jcfg.GpuPartitionerConfig, tcfg.GpuPartitionerConfig, "forecast_small_pod_chips", 0, {}),
    (jcfg.OperatorConfig, tcfg.OperatorConfig, "tpu_chip_memory_gb", 0, {}),
    (jcfg.TpuAgentConfig, tcfg.AgentConfig, "report_config_interval_seconds", 0.0, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "scale_up_burn_threshold", 0.0, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "scale_down_burn_threshold", 2.0, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "scale_down_burn_threshold", -0.5, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "scale_down_stable_seconds", -1.0, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "recent_activity_seconds", -1.0, {}),
    (jcfg.AutoscalerConfig, tcfg.AutoscalerConfig, "resync_seconds", 0.0, {}),
    (jcfg.SchedulerConfig, tcfg.SchedulerConfig, "retry_seconds", 0.0, {}),
]


@pytest.mark.parametrize("ref_cls,port_cls,field,value,extra", BAD_VALUES,
                         ids=[f"{c[0].__name__}-{c[2]}={c[3]}" for c in BAD_VALUES])
def test_validate_raises_on_the_same_bad_values(ref_cls, port_cls, field, value, extra):
    ref = ref_cls(**{field: value}, **extra)
    port = port_cls(**{FIELD_NAMES.get(field, field): value}, **extra)
    with pytest.raises(jcfg.ConfigError) as want:
        ref.validate()
    with pytest.raises(tcfg.ConfigError) as got:
        port.validate()
    message = str(want.value)
    for ref_name, port_name in FIELD_NAMES.items():
        message = message.replace(ref_name, port_name)
    assert str(got.value) == message


@pytest.mark.parametrize("field,value,waits", [("forecast_enabled", True, True),
                                               ("audit_sample_rate", 0.5, False)],
                         ids=["forecast_enabled-True", "audit_sample_rate-0.5"])
def test_what_waits_for_item_18b_is_refused(field, value, waits):
    """The forecaster's thread waits for item 18b.3 and is refused; the
    auditor came with item 18b.2 and its rate is accepted, as the
    reference accepts both."""
    jcfg.GpuPartitionerConfig(**{field: value}).validate()  # the reference runs it
    if waits:
        with pytest.raises(tcfg.ConfigError, match="item 18b"):
            tcfg.GpuPartitionerConfig(**{field: value}).validate()
    else:
        tcfg.GpuPartitionerConfig(**{field: value}).validate()
        assert trun.configs_from(
            {"partitioner": {"auditSampleRate": value}}).partitioner.audit_sample_rate == value
    with pytest.raises(tcfg.ConfigError, match="item 18b"):
        trun.configs_from({"partitioner": {"forecastEnabled": True}})


def test_every_valid_default_validates():
    for cfg in (tcfg.GpuPartitionerConfig(), tcfg.OperatorConfig(), tcfg.AgentConfig(),
                tcfg.AutoscalerConfig(), tcfg.SchedulerConfig()):
        cfg.validate()
    with pytest.raises(ValueError, match="not supported"):
        trun.seed_node({"name": "h", "partitioning": "hybrid"})


# ------------------------------------------------------- JSON-first loading


@pytest.fixture
def no_yaml(monkeypatch):
    """``import yaml`` raises ImportError, as where PyYAML is missing."""
    monkeypatch.setitem(sys.modules, "yaml", None)


def _kubeconfig(tmp_path, server):
    doc = {"apiVersion": "v1", "kind": "Config", "current-context": "stub",
           "clusters": [{"name": "stub", "cluster": {"server": server}}],
           "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
           "users": [{"name": "stub", "user": {"token": "t0k"}}]}
    path = tmp_path / "kubeconfig.json"
    path.write_text(json.dumps(doc))
    return path


def test_json_documents_load_without_yaml(no_yaml, tmp_path):
    from nos_tpu_torch.kube.apiclient import load_kubeconfig

    with pytest.raises(ImportError):
        import yaml  # noqa: F401
    config = tmp_path / "suite.json"
    config.write_text(json.dumps({"scheduler": {"retrySeconds": 0.25}}))
    assert trun.configs_from(trun.load_config(str(config))).scheduler.retry_seconds == 0.25
    creds = load_kubeconfig(str(_kubeconfig(tmp_path, "http://127.0.0.1:1")))
    assert (creds.server, creds.token) == ("http://127.0.0.1:1", "t0k")
    with pytest.raises(RuntimeError, match="PyYAML"):
        trun.load_config(str(ROOT / "nos_tpu_torch/examples/suite.yaml"))


def test_a_component_runs_from_json_without_yaml(no_yaml, tmp_path):
    from nos_tpu_torch.cmd import scheduler as cmd_scheduler
    from nos_tpu_torch.sim.apiserver import StubApiServer

    with StubApiServer() as server:
        config = tmp_path / "scheduler.json"
        config.write_text(json.dumps({
            "store": {"type": "kubeconfig", "kubeconfig": str(_kubeconfig(tmp_path, server.url)),
                      "kinds": ["Node", "Pod", "ConfigMap"]},
            "manager": {"healthProbeHost": "127.0.0.1"}}))
        started = threading.Event()
        stop = threading.Event()
        result = {}

        def run():
            from nos_tpu_torch.cmd._component import run_component

            result["rc"] = run_component(
                "scheduler", lambda m, c: cmd_scheduler.build_scheduler(
                    m, trun.configs_from(c).scheduler),
                ["--config", str(config), "--health-port", "0"], stop_event=stop,
                on_started=lambda info: (result.update(info), started.set()))

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        assert started.wait(30)
        assert type(result["manager"].store).__name__ == "KubeApiStore"
        stop.set()
        thread.join(10)
        assert result["rc"] == 0
