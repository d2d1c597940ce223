"""The MIG node agent (nos_tpu_torch.controllers.migagent), its device
plugin and partitioner, against nos_tpu's tpuagent on the same inputs.

Each reference test of tests/controllers/test_tpuagent.py's
TestActuatorReporterLoop and TestCapacityClamp is re-told on
``SimMigClient`` with H100 profiles and run beside the reference, step
for step: one v5e 2x4 board (8 chips) against one H100 (8 memory
slices, 7 compute slices), each topology mapped to the MIG profile with
as many memory slices as it has chips (``1x1`` → ``1g.10gb``, ``1x2`` →
``1g.20gb``, ``2x2`` → ``3g.40gb``, ``2x4`` → ``7g.80gb``). After every
step the two sides must agree exactly, keys and profiles translated: the
instances, the spec, status and plan annotations, the advertised
instances in allocatable, the plugin restarts and the acks. Where the
H100 differs from a board of chips (first-fit placement, NVML's MIG
mode) the port is held to its own contract: a placement refusal after
the clamp, the MIG-off refusal over a fake NVML, the advertiser's
``nvidia.com/gpu``, and the MIG and MPS reporters each keeping to their
own keys (the split held against ``is_sharing_status_key``).
"""
import logging
import random
import threading
import time

import pytest

from nos_tpu.api.v1alpha1 import annotations as jannot
from nos_tpu.controllers.tpuagent import SharedState as JShared
from nos_tpu.controllers.tpuagent import TpuActuator, TpuReporter
from nos_tpu.device import SimDevicePlugin as JPlugin
from nos_tpu.device import SimDevicePool, SimTpuDeviceClient, TpuClient
from nos_tpu.device import SimPodResourcesClient as JPodResources
from nos_tpu.kube.controller import Request
from nos_tpu.kube.store import KubeStore
from nos_tpu.util.tracing import Tracer as JTracer
from nos_tpu_torch.controllers.migagent import (
    MigActuator,
    MigReporter,
    SharedState,
    build_migagent,
)
from nos_tpu_torch.controllers.mpsagent import MpsReporter
from nos_tpu_torch.device import nvml
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.device.sharing import SharedSliceClient
from nos_tpu_torch.device.sim import (
    DevicePluginAdvertiser,
    SimDevicePlugin,
    SimMigClient,
    SimMigPool,
    SimPodResourcesClient,
)
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import (
    PARTITIONING_LABEL,
    PARTITIONING_MIG,
    PARTITIONING_MPS,
    RESOURCE_GPU,
    mig_resource,
)
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.mig import MigNodeInitializer, MigPartitioner
from nos_tpu_torch.partitioning.mps import MpsPartitioner
from nos_tpu_torch.util import metrics
from nos_tpu_torch.util.tracing import Tracer
from tests.factory import build_pod, build_tpu_node, slice_res
from tests.test_torch_device import _FakeNvml, _nvml_over

TO_MIG = {"1x1": "1g.10gb", "1x2": "1g.20gb", "2x2": "3g.40gb", "2x4": "7g.80gb"}


def mig(geometry):
    """{board: {topology: n}} → {GPU: {MIG profile: n}}."""
    return {b: {TO_MIG[p]: n for p, n in g.items()} for b, g in geometry.items()}


def mig_key(key: str) -> str:
    """A reference annotation key in the port's form."""
    for head in ("spec-tpu-", "status-tpu-"):
        if head in key:
            prefix, rest = key.split(head)
            index, tail = rest.split("-", 1)
            profile, _, status = tail.partition("-")
            return (prefix + head.replace("tpu", "gpu") + index + "-" + TO_MIG.get(profile, profile)
                    + ("-" + status if status else ""))
    return key


class Pair:
    """The reference's agent on a 2x4 board and the port's on one H100,
    driven by the same calls."""

    def __init__(self):
        self.rstore = KubeStore()
        self.rstore.create(build_tpu_node(name="n1"))
        self.rpool = SimDevicePool()
        rclient = TpuClient(SimTpuDeviceClient(self.rpool), JPodResources(self.rstore,
                                                                         self.rpool.get))
        self.rplugin = JPlugin(self.rstore, self.rpool)
        self.rshared = JShared()
        self.rreporter = TpuReporter(self.rstore, rclient, "n1", self.rshared, 10)
        self.ractuator = TpuActuator(self.rstore, rclient, self.rplugin, "n1", self.rshared)

        self.store = NodeStore()
        self.store.create(Node("n1", labels={GPU_PRODUCT_LABEL: H100_80GB,
                                             PARTITIONING_LABEL: PARTITIONING_MIG},
                               capacity={RESOURCE_GPU: 1}, allocatable={RESOURCE_GPU: 1}))
        self.pool = SimMigPool()
        sim = SimMigClient(self.pool, "n1")
        client = GpuClient(sim, SimPodResourcesClient(self.store, "n1", sim.get_mig_devices))
        self.plugin = SimDevicePlugin(self.store, self.pool)
        self.shared = SharedState()
        self.reporter = MigReporter(self.store, client, "n1", self.shared)
        self.actuator = MigActuator(self.store, client, self.plugin, "n1", self.shared)
        self.restarts = [0, 0]
        for i, plugin in enumerate((self.rplugin, self.plugin)):
            real = plugin.restart

            def counting(node, real=real, i=i):
                self.restarts[i] += 1
                real(node)

            plugin.restart = counting

    def spec(self, geometry, plan):
        def patch(annotations, codec, geometries):
            p = codec.strip_spec_annotations(annotations)
            p.update(codec.spec_from_geometries(geometries))
            p[codec.SPEC_PARTITIONING_PLAN] = plan
            return p

        self.rstore.patch_annotations("Node", "n1", "", patch(
            self.rstore.get("Node", "n1").metadata.annotations, jannot, geometry))
        self.store.patch_annotations("Node", "n1", "", patch(
            self.store.get("Node", "n1").annotations, annot, mig(geometry)))

    def create(self, topology, n):
        self.rpool.create("n1", 0, topology, n)
        self.pool.create("n1", 0, TO_MIG[topology], n)

    def pod(self, name, topology, n=1, phase=PodPhase.RUNNING):
        self.rstore.create(build_pod(name, {slice_res(topology): n}, node="n1", phase=phase))
        self.store.create(Pod(name, "default", "n1", phase,
                              {mig_resource(TO_MIG[topology]): n}))

    def report(self):
        self.rreporter.reconcile(Request(name="n1"))
        self.reporter.reconcile()

    def on_report(self):
        self.rshared.on_report()
        self.shared.on_report()

    def actuate(self):
        r = self.ractuator.reconcile(Request(name="n1"))
        p = self.actuator.reconcile()
        assert (r is not None and r.requeue_after > 0) == (p is not None and p > 0)
        return p

    def check(self):
        """Both sides the same, translated."""
        assert mig(self.rpool.geometry("n1")) == self.pool.geometry("n1")
        rnode, node = self.rstore.get("Node", "n1"), self.store.get("Node", "n1")
        assert {mig_key(k): v for k, v in rnode.metadata.annotations.items()} == \
            node.annotations
        slices = {k: v for k, v in rnode.status.allocatable.items()
                  if k.startswith("google.com/tpu-slice-")}
        assert {mig_resource(TO_MIG[k.rsplit("-", 1)[1]]): v for k, v in slices.items()} == \
            {k: v for k, v in node.allocatable.items() if k.startswith("nvidia.com/mig-")}
        assert self.restarts[0] == self.restarts[1]
        assert self.rshared.last_applied_plan_id == self.shared.last_applied_plan_id
        return node


def status_geometry(node):
    _, status = annot.parse_node_annotations(node.annotations)
    return annot.status_geometries(status)


# --------------------------------------------- TestActuatorReporterLoop


def test_spec_to_devices_to_status_handshake():
    pair = Pair()
    pair.spec({0: {"2x2": 2}}, "7")
    assert pair.actuate() > 0  # gated until a report
    assert pair.pool.get("n1") == []
    pair.check()
    pair.report()
    pair.actuate()
    node = pair.check()
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 2}}
    assert node.allocatable[mig_resource("3g.40gb")] == 2
    assert node.allocatable[RESOURCE_GPU] == 0 and node.capacity[RESOURCE_GPU] == 1
    pair.report()
    node = pair.check()
    assert status_geometry(node) == {0: {"3g.40gb": 2}}
    assert node.annotations[annot.STATUS_PARTITIONING_PLAN] == "7"


def test_reporter_marks_used_devices():
    pair = Pair()
    pair.create("2x2", 2)
    pair.pod("p", "2x2")
    pair.report()
    node = pair.check()
    _, status = annot.parse_node_annotations(node.annotations)
    assert {(s.status, s.profile): s.quantity for s in status} == {
        ("used", "3g.40gb"): 1, ("free", "3g.40gb"): 1}


def test_reconverge_after_spec_change_keeps_used_instances():
    pair = Pair()
    pair.spec({0: {"2x4": 1}}, "1")
    pair.report()
    pair.actuate()
    pair.check()
    assert pair.pool.geometry("n1") == {0: {"7g.80gb": 1}}
    # a new plan: re-carve into a 3g.40gb and two 1g.20gb
    pair.spec({0: {"2x2": 1, "1x2": 2}}, "2")
    pair.report()
    pair.actuate()
    pair.check()
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 1, "1g.20gb": 2}}
    pair.report()
    assert pair.check().annotations[annot.STATUS_PARTITIONING_PLAN] == "2"
    # a pod holds a 1g.20gb; the next plan drops 1g.20gb: the used one stays
    pair.pod("busy", "1x2")
    pair.spec({0: {"2x2": 1, "1x1": 2}}, "3")
    pair.report()
    pair.actuate()
    pair.check()
    assert pair.pool.geometry("n1")[0]["1g.20gb"] == 1
    pair.report()
    node = pair.check()
    assert node.annotations[annot.STATUS_PARTITIONING_PLAN] == "3"  # acked, diverging


def test_actuator_of_a_missing_node_does_nothing():
    store = NodeStore()
    pool = SimMigPool()
    sim = SimMigClient(pool, "gone")
    client = GpuClient(sim, SimPodResourcesClient(store, "gone", sim.get_mig_devices))
    shared = SharedState()
    shared.on_report()
    assert MigActuator(store, client, SimDevicePlugin(store, pool), "gone", shared).reconcile() \
        is None
    MigReporter(store, client, "gone", shared).reconcile()  # no node: no report, no error


# --------------------------------------------------------- TestCapacityClamp


def _full_of_used(pair):
    pair.create("2x2", 2)
    pair.pod("a", "2x2")
    pair.pod("b", "2x2")


def test_creates_clamped_when_spec_exceeds_the_gpu():
    pair = Pair()
    _full_of_used(pair)
    pair.spec({0: {"2x2": 1, "1x2": 2}}, "p1")  # stale: 12 slices
    pair.on_report()
    pair.actuate()
    pair.check()
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 2}}  # used never deleted


def test_partial_clamp_creates_what_fits_and_acks():
    pair = Pair()
    pair.create("2x2", 1)
    pair.pod("a", "2x2")
    pair.spec({0: {"2x2": 1, "1x2": 3}}, "p1")  # 10 slices, 8 fit
    pair.report()
    pair.actuate()
    pair.check()
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 1, "1g.20gb": 2}}
    assert pair.restarts == [1, 1]
    pair.report()
    assert pair.check().annotations[annot.STATUS_PARTITIONING_PLAN] == "p1"


def test_fully_clamped_plan_skips_the_plugin_restart_and_acks():
    pair = Pair()
    _full_of_used(pair)
    pair.spec({0: {"2x2": 2, "1x2": 2}}, "p1")
    for _ in range(5):
        pair.on_report()
        pair.actuate()
        pair.check()
    assert pair.restarts == [0, 0]
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 2}}
    pair.report()
    assert pair.check().annotations[annot.STATUS_PARTITIONING_PLAN] == "p1"


def test_clamp_log_throttled_per_plan(caplog):
    pair = Pair()
    _full_of_used(pair)
    pair.spec({0: {"2x2": 2, "1x2": 2}}, "p1")
    with caplog.at_level(logging.ERROR):
        for _ in range(6):
            pair.on_report()
            pair.actuate()
        pair.spec({0: {"2x2": 2, "1x2": 1}}, "p2")
        for _ in range(3):
            pair.on_report()
            pair.actuate()
    counts = {name: sum(1 for r in caplog.records if r.name == name and "clamping" in
                        r.getMessage() and r.levelno == logging.ERROR)
              for name in ("nos_tpu.tpuagent", "nos_tpu_torch.migagent")}
    assert counts["nos_tpu_torch.migagent"] == counts["nos_tpu.tpuagent"] == 2, counts


def test_a_gpu_beyond_the_capacity_drops_its_creates(caplog):
    pair = Pair()
    pair.spec({0: {"2x2": 1}, 1: {"2x2": 1}}, "p1")
    with caplog.at_level(logging.ERROR, logger="nos_tpu_torch.migagent"):
        pair.report()
        pair.actuate()
        pair.check()
        # the stale spec still names GPU 1: each pass drops it again, and
        # the error is logged once for the plan
        for _ in range(2):
            pair.on_report()
            pair.actuate()
            pair.check()
    assert pair.pool.geometry("n1") == {0: {"3g.40gb": 1}}
    errors = [r for r in caplog.records if r.name == "nos_tpu_torch.migagent"
              and "spec names GPU 1" in r.getMessage() and r.levelno == logging.ERROR]
    assert len(errors) == 1, errors


# ---------------------------------------------------- where the H100 differs


def _port_env(gpus=1):
    store = NodeStore()
    store.create(Node("n1", labels={GPU_PRODUCT_LABEL: H100_80GB}, capacity={RESOURCE_GPU: gpus},
                      allocatable={RESOURCE_GPU: gpus}))
    pool = SimMigPool()
    sim = SimMigClient(pool, "n1")
    client = GpuClient(sim, SimPodResourcesClient(store, "n1", sim.get_mig_devices))
    plugin = SimDevicePlugin(store, pool)
    restarts = []
    real = plugin.restart
    plugin.restart = lambda node: (restarts.append(node), real(node))
    agent = build_migagent(store, "n1", client, plugin, interval=0.005)
    return store, pool, agent, restarts


def _spec(store, geometries, plan):
    p = annot.strip_spec_annotations(store.get("Node", "n1").annotations)
    p.update(annot.spec_from_geometries(geometries))
    p[annot.SPEC_PARTITIONING_PLAN] = plan
    store.patch_annotations("Node", "n1", "", p)


def test_a_placement_refusal_after_the_clamp_acks_without_a_restart(caplog):
    store, pool, agent, restarts = _port_env()
    pool.create("n1", 0, "1g.10gb", 1)  # start 0
    store.create(Pod("a", "default", "n1", PodPhase.RUNNING, {mig_resource("1g.10gb"): 1}))
    # 4g.40gb fits the slices left (7 memory, 6 compute) but starts only at 0
    _spec(store, {0: {"1g.10gb": 1, "4g.40gb": 1}}, "p1")
    with caplog.at_level(logging.ERROR, logger="nos_tpu_torch.migagent"):
        for _ in range(3):
            agent.step()
    refusals = [r for r in caplog.records if "no creation order" in r.getMessage()]
    assert len(refusals) == 1  # logged once for the plan
    assert restarts == []
    assert pool.geometry("n1") == {0: {"1g.10gb": 1}}
    node = store.get("Node", "n1")
    assert node.annotations[annot.STATUS_PARTITIONING_PLAN] == "p1"
    assert status_geometry(node) == {0: {"1g.10gb": 1}}  # the true geometry


def test_a_refusal_after_deletes_restarts_the_plugin_and_acks():
    store, pool, agent, restarts = _port_env()
    pool.create("n1", 0, "1g.10gb", 2)  # starts 0, 1
    store.create(Pod("a", "default", "n1", PodPhase.RUNNING, {mig_resource("1g.10gb"): 1}))
    # the free one goes; 4g.40gb is still refused (slice 0 is used)
    _spec(store, {0: {"1g.10gb": 1, "4g.40gb": 1}}, "p1")
    agent.step()
    assert pool.geometry("n1") == {0: {"1g.10gb": 1}}
    assert restarts == ["n1"]
    assert store.get("Node", "n1").annotations[annot.STATUS_PARTITIONING_PLAN] == "p1"


def test_another_error_raises_and_is_not_acked():
    store, pool, agent, restarts = _port_env()
    _spec(store, {0: {"3g.40gb": 1}}, "p1")

    def broken(gpu, profiles):
        raise RuntimeError("NVML gone")

    agent.actuator.client.create_devices = broken
    with pytest.raises(RuntimeError, match="NVML gone"):
        agent.step()
    assert annot.STATUS_PARTITIONING_PLAN not in store.get("Node", "n1").annotations


class _MigOffNvml(_FakeNvml):
    def __init__(self, current=0, pending=0):
        super().__init__(mig_on=False)
        self.modes = (current, pending)

    def nvmlDeviceGetMigMode(self, device, current, pending):
        self._set(current, self.modes[0])
        self._set(pending, self.modes[1])
        return 0


@pytest.mark.parametrize("modes", [(0, 0), (0, 1)])
def test_build_migagent_refuses_a_gpu_with_mig_off(modes):
    client = nvml.NvmlMigClient(_nvml_over(_MigOffNvml(*modes)))
    store = NodeStore()
    store.create(Node("n1", capacity={RESOURCE_GPU: 1}))
    gpu_client = GpuClient(client, SimPodResourcesClient(store, "n1", lambda: []))
    with pytest.raises(nvml.MigModeDisabledError,
                       match=rf"GPU 0: MIG mode disabled \(current {modes[0]}, "
                             rf"pending {modes[1]}\)"):
        build_migagent(store, "n1", gpu_client, DevicePluginAdvertiser(store, lambda n: {}))
    # NVML's "Not Supported" is never an empty report
    reporter = MigReporter(store, gpu_client, "n1", SharedState())
    with pytest.raises(nvml.NvmlError, match="Not Supported"):
        reporter.reconcile()
    assert store.get("Node", "n1").annotations == {}


def test_build_migagent_over_nvml_with_mig_on_runs_the_loop():
    fake = _FakeNvml()
    fake.nvmlDeviceGetMigMode = lambda d, c, p: (fake._set(c, 1), fake._set(p, 1), 0)[2]
    client = nvml.NvmlMigClient(_nvml_over(fake))
    store = NodeStore()
    store.create(Node("n1", labels={GPU_PRODUCT_LABEL: H100_80GB}, capacity={RESOURCE_GPU: 1}))
    gpu_client = GpuClient(client, SimPodResourcesClient(store, "n1",
                                                         client.get_mig_devices))
    agent = build_migagent(store, "n1", gpu_client, DevicePluginAdvertiser(
        store, lambda n: {0: {d.profile: 1 for d in client.get_mig_devices()}}))
    _spec(store, {0: {"1g.10gb": 1}}, "1")
    agent.step()
    assert [d.profile for d in client.get_mig_devices()] == ["1g.10gb"]
    assert store.get("Node", "n1").annotations[annot.STATUS_PARTITIONING_PLAN] == "1"
    _spec(store, {}, "2")
    agent.step()
    assert client.get_mig_devices() == [] and fake.gis == {}
    assert store.get("Node", "n1").annotations[annot.STATUS_PARTITIONING_PLAN] == "2"


def test_the_advertiser_counts_gpus_without_instances():
    store, pool, agent, _ = _port_env(gpus=3)
    _spec(store, {0: {"3g.40gb": 2}, 2: {"1g.10gb": 3}}, "1")
    agent.step()
    node = store.get("Node", "n1")
    assert {k: v for k, v in node.allocatable.items() if k.startswith("nvidia.com/")} == {
        mig_resource("3g.40gb"): 2, mig_resource("1g.10gb"): 3, RESOURCE_GPU: 1}
    assert node.capacity == {RESOURCE_GPU: 3}
    _spec(store, {}, "2")
    agent.step()
    assert store.get("Node", "n1").allocatable == {RESOURCE_GPU: 3}


def test_the_polled_loop_acks_a_spec_and_counts_instances():
    store, pool, agent, _ = _port_env()
    created = metrics.MIG_INSTANCES_CREATED.labels(profile="3g.40gb").value
    deleted = metrics.MIG_INSTANCES_DELETED.labels(profile="7g.80gb").value
    agent.start()
    try:
        for geometry, plan in (({0: {"7g.80gb": 1}}, "1"), ({0: {"3g.40gb": 2}}, "2")):
            _spec(store, geometry, plan)
            deadline = time.monotonic() + 10
            while store.get("Node", "n1").annotations.get(
                    annot.STATUS_PARTITIONING_PLAN) != plan:
                assert time.monotonic() < deadline, "no ack"
                time.sleep(0.002)
    finally:
        agent.stop()
    assert agent.error is None
    assert pool.geometry("n1") == {0: {"3g.40gb": 2}}
    assert metrics.MIG_INSTANCES_CREATED.labels(profile="3g.40gb").value == created + 2
    assert metrics.MIG_INSTANCES_DELETED.labels(profile="7g.80gb").value == deleted + 1


def test_the_reconfig_span_parents_on_the_linked_apply():
    from nos_tpu_torch.util import tracing

    store, pool, agent, _ = _port_env()
    with tracing.TRACER.span("partitioner.apply") as apply:
        tracing.TRACER.link(("reconfig", "n1", "p9"), apply)
        _spec(store, {0: {"2g.20gb": 3}}, "p9")
        agent.step()
    trace = next(t for t in tracing.TRACER.store.list() if t.trace_id == apply.trace_id)
    reconfig = [s for s in trace.spans if s.name == "migagent.reconfig"]
    assert len(reconfig) == 1 and reconfig[0].parent_id == apply.span_id
    assert reconfig[0].attributes == {"node": "n1", "plan_id": "p9", "deleted": 0,
                                      "created": 3}
    assert tracing.TRACER.linked(("reconfig", "n1", "p9")) is None  # consumed
    # no link: no span
    _spec(store, {0: {"2g.20gb": 2}}, "p10")
    n = len(tracing.TRACER.store.list())
    agent.step()
    assert len(tracing.TRACER.store.list()) == n


def test_links_behave_as_the_reference_tracer():
    ref, port = JTracer(), Tracer()
    ref.MAX_LINKS = port.MAX_LINKS = 3
    rng = random.Random(4)
    for i in range(20):
        key = rng.randint(0, 5)
        if rng.random() < 0.6:
            ref.link(key, ref.start_span(f"s{i}"))
            port.link(key, port.start_span(f"s{i}"))
        else:
            pop = rng.random() < 0.5
            r, p = ref.linked(key, pop=pop), port.linked(key, pop=pop)
            assert (r is None) == (p is None)
            assert r is None or r.name == p.name
    port.link("k", None)
    assert port.linked("k") is None


# ----------------------------------------------- MIG and MPS reporters


@pytest.mark.parametrize("seed", range(3))
def test_mig_and_mps_status_keys_split_as_the_reference_splits(seed):
    rng = random.Random(seed)
    profiles = ["1x1", "1x2", "2x2", "2x4", "8gb", "16gb", "20gb"]
    for _ in range(50):
        key = jannot.StatusAnnotation(rng.randint(0, 7), rng.choice(profiles),
                                      rng.choice(["free", "used"]), 1).key
        assert annot.is_mps_status_key(mig_key(key)) == jannot.is_sharing_status_key(key)
        assert annot.is_mig_status_key(mig_key(key)) == (not jannot.is_sharing_status_key(key))
    for key in (annot.SPEC_PARTITIONING_PLAN, annot.STATUS_PARTITIONING_PLAN,
                "nos.nebuly.com/spec-gpu-0-20gb"):
        assert not annot.is_mig_status_key(key) and not annot.is_mps_status_key(key)
    assert (annot.SPEC_PARTITIONING_PLAN, annot.STATUS_PARTITIONING_PLAN) == (
        jannot.SPEC_PARTITIONING_PLAN, jannot.STATUS_PARTITIONING_PLAN)


def test_strip_spec_annotations_matches_the_reference():
    rng = random.Random(7)
    ref_ann = {jannot.SpecAnnotation(rng.randint(0, 3), p, 1).key: "1"
               for p in ("1x1", "2x2", "8gb") for _ in range(3)}
    ref_ann.update({"other": "x", jannot.SPEC_PARTITIONING_PLAN: "3",
                    jannot.StatusAnnotation(0, "2x2", "free", 1).key: "1"})
    assert annot.strip_spec_annotations({mig_key(k): v for k, v in ref_ann.items()}) == {
        mig_key(k): None for k in jannot.strip_spec_annotations(ref_ann)}


def test_the_two_reporters_never_delete_each_others_keys():
    store, pool, agent, _ = _port_env()
    store.patch_labels("Node", "n1", "", {PARTITIONING_LABEL: PARTITIONING_MPS})
    MpsPartitioner(store).apply_partitioning("n1", "m1", {1: {"20gb": 2}})
    _spec(store, {0: {"3g.40gb": 2}}, "g1")
    agent.step()
    mps = MpsReporter(store, SharedSliceClient(store), "n1")
    mps.reconcile()
    both = dict(store.get("Node", "n1").annotations)
    assert both[annot.StatusAnnotation(0, "3g.40gb", "free", 2).key] == "2"
    assert both[annot.StatusAnnotation(1, "20gb", "free", 2).key] == "2"
    assert both[annot.STATUS_PARTITIONING_PLAN] == "g1"
    for _ in range(2):
        agent.step()
        mps.reconcile()
    assert store.get("Node", "n1").annotations == both
    # each one's change leaves the other's keys
    MpsPartitioner(store).apply_partitioning("n1", "m2", {1: {"40gb": 1}})
    mps.reconcile()
    agent.step()
    ann = store.get("Node", "n1").annotations
    assert annot.StatusAnnotation(1, "40gb", "free", 1).key in ann
    assert annot.StatusAnnotation(1, "20gb", "free", 2).key not in ann
    assert ann[annot.StatusAnnotation(0, "3g.40gb", "free", 2).key] == "2"
    # the MPS reporter refuses a node labelled for MIG
    store.patch_labels("Node", "n1", "", {PARTITIONING_LABEL: PARTITIONING_MIG})
    MpsPartitioner(store).apply_partitioning("n1", "m3", {1: {"10gb": 8}})
    mps.reconcile()
    # only the partitioner's plan stamp changed; the reporter wrote nothing
    assert store.get("Node", "n1").annotations == ann | {annot.SPEC_PARTITIONING_PLAN: "m3"}


# ------------------------------------------------ partitioner, initializer


def test_partitioner_and_initializer_match_the_reference():
    from nos_tpu.partitioning.core.partition_state import BoardPartitioning, NodePartitioning
    from nos_tpu.partitioning.tpu import TpuNodeInitializer, TpuPartitioner

    rstore = KubeStore()
    rstore.create(build_tpu_node(name="n1", annotations={"keep": "me"}))
    store = NodeStore()
    store.create(Node("n1", labels={GPU_PRODUCT_LABEL: H100_80GB}, capacity={RESOURCE_GPU: 1},
                      annotations={"keep": "me"}))
    rids, ids = iter(["1", "2", "3"]), iter(["1", "2", "3"])
    rinit = TpuNodeInitializer(TpuPartitioner(rstore), lambda: next(rids))
    init = MigNodeInitializer(MigPartitioner(store), lambda: next(ids))
    assert not rinit.is_initialized(rstore.get("Node", "n1"))
    assert not init.is_initialized(store.get("Node", "n1"))
    assert rinit.init_node_partitioning(rstore.get("Node", "n1"))
    assert init.init_node_partitioning(store.get("Node", "n1"))

    def same():
        assert {mig_key(k): v for k, v in rstore.get("Node", "n1").metadata.annotations.items()} \
            == store.get("Node", "n1").annotations

    same()
    assert store.get("Node", "n1").annotations[
        annot.SpecAnnotation(0, "7g.80gb", 1).key] == "1"
    # initialized by its spec; a caller checks that first, as the
    # reference's node controller does
    assert init.is_initialized(store.get("Node", "n1"))
    assert rinit.is_initialized(rstore.get("Node", "n1"))
    for geometry, plan in (({0: {"2x2": 2}}, "p2"), ({0: {"1x2": 1, "1x1": 2}}, "p3")):
        TpuPartitioner(rstore).apply_partitioning("n1", plan, NodePartitioning(boards=[
            BoardPartitioning(board_index=b, resources={slice_res(p): n for p, n in g.items()})
            for b, g in geometry.items()]))
        MigPartitioner(store).apply_partitioning("n1", plan, mig(geometry))
        same()
    MigPartitioner(store).apply_partitioning("gone", "p4", {0: {"7g.80gb": 1}})  # no error


def test_init_node_partitioning_skips_a_node_that_is_no_gpu_node():
    store = NodeStore()
    store.create(Node("cpu-0", capacity={"cpu": 8}))
    init = MigNodeInitializer(MigPartitioner(store), lambda: "1")
    assert not init.init_node_partitioning(store.get("Node", "cpu-0"))
    assert store.get("Node", "cpu-0").annotations == {}


def test_the_agent_start_stop_leaves_no_thread():
    store, pool, agent, _ = _port_env()
    before = threading.active_count()
    agent.start()
    agent.stop()
    assert threading.active_count() == before
