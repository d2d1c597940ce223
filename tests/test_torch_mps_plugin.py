"""The MPS actuation path (nos_tpu_torch.partitioning.mps,
nos_tpu_torch.device.sharing, nos_tpu_torch.controllers.mpsagent)
against nos_tpu's sharing strategy on the same inputs.

TestSharingPartitioner, TestSimSharedDevicePlugin and
TestSharedSliceClientAndReporter of tests/partitioning/
test_sharing_strategy.py are re-told with NVIDIA's names and run beside
the reference: a sharing node of 4 chips against an MPS node of 4 GPUs,
``google.com/tpu-mem-<N>gb`` against ``nvidia.com/gpu-<N>gb``, the
label ``google.com/tpu-device-plugin.config`` against
``nvidia.com/device-plugin.config``, a config entry's ``chips`` against
``devices`` and ``google.com/tpu`` against ``nvidia.com/gpu``. Exact
after translation: the config map's keys and entries, the label, the
allocatable, the slices each GPU reports free or used (in order) and the
status annotations, also over seeded random plans and pods.
"""
import json
import random

import pytest

from nos_tpu.api.v1alpha1 import annotations as jannot
from nos_tpu.api.v1alpha1 import constants, labels
from nos_tpu.controllers.sharingagent import SharingReporter
from nos_tpu.device.sharing import SharedSliceClient as JSliceClient
from nos_tpu.device.sharing import SimSharedDevicePlugin as JPlugin
from nos_tpu.device.sharing import load_plugin_config as jload
from nos_tpu.kube.controller import Request
from nos_tpu.kube.store import KubeStore
from nos_tpu.partitioning.core.partition_state import BoardPartitioning, NodePartitioning
from nos_tpu.partitioning.sharing import SharingPartitioner
from nos_tpu_torch.controllers.mpsagent import MpsReporter
from nos_tpu_torch.device.sharing import (
    DEVICE_PLUGIN_CONFIG_LABEL,
    SharedSliceClient,
    SimSharedDevicePlugin,
    load_plugin_config,
)
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import (
    PARTITIONING_LABEL,
    PARTITIONING_MIG,
    PARTITIONING_MPS,
    RESOURCE_GPU,
    mps_resource,
)
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.partitioning.mps import MpsPartitioner, plugin_config_from_geometries
from tests.factory import build_pod, build_tpu_node

CM = "nos-device-plugin-config"


def mem(gb):
    return constants.tpu_shared_resource(gb)


def gpu_name(name: str) -> str:
    if name == constants.RESOURCE_TPU:
        return RESOURCE_GPU
    if name.startswith("google.com/tpu-mem-"):
        return mps_resource(name.rsplit("-", 1)[1])
    return name


def gpu_entry(entry: dict) -> dict:
    out = {("devices" if k == "chips" else k): v for k, v in entry.items()}
    out["name"], out["rename"] = gpu_name(entry["name"]), gpu_name(entry["rename"])
    return out


def gpu_config(config):
    if config is None:
        return None
    sharing = dict(config["sharing"])
    sharing["resources"] = [gpu_entry(e) for e in sharing["resources"]]
    return {**config, "sharing": sharing}


def gpu_key(key: str) -> str:
    return key.replace("-tpu-", "-gpu-")


class Pair:
    def __init__(self, names=("shared-0",), chips=4, kind="sharing"):
        self.rstore, self.store = KubeStore(), NodeStore()
        for name in names:
            self.rstore.create(build_tpu_node(name=name, chips=chips, partitioning=kind))
            self.store.create(Node(name, labels={
                GPU_PRODUCT_LABEL: H100_80GB,
                PARTITIONING_LABEL: PARTITIONING_MPS if kind == "sharing" else PARTITIONING_MIG},
                capacity={RESOURCE_GPU: chips}, allocatable={RESOURCE_GPU: chips}))
        self.rpart, self.part = SharingPartitioner(self.rstore, CM), MpsPartitioner(self.store, CM)
        self.rplugin, self.plugin = JPlugin(self.rstore, CM), SimSharedDevicePlugin(self.store, CM)

    def apply(self, node, plan, geometries):
        self.rpart.apply_partitioning(node, plan, NodePartitioning(boards=[
            BoardPartitioning(board_index=b, resources={mem(int(p[:-2])): n for p, n in g.items()})
            for b, g in geometries.items()]))
        self.part.apply_partitioning(node, plan, geometries)

    def reconcile(self, node):
        self.rplugin.reconcile(Request(name=node))
        self.plugin.reconcile(node)

    def pod(self, name, gb, node="shared-0", n=1):
        self.rstore.create(build_pod(name, {mem(gb): n}, ns="ml", node=node,
                                     phase="Running"))
        self.store.create(Pod(name, "ml", node, PodPhase.RUNNING, {mps_resource(f"{gb}gb"): n}))

    def check(self, node="shared-0"):
        rcm = self.rstore.try_get("ConfigMap", CM)
        cm = self.store.try_get("ConfigMap", CM)
        assert (rcm is None) == (cm is None)
        if cm is not None:
            assert list(rcm.data) == list(cm.data)
            for key in cm.data:
                assert gpu_config(json.loads(rcm.data[key])) == json.loads(cm.data[key])
        rn, n = self.rstore.get("Node", node), self.store.get("Node", node)
        assert rn.metadata.labels.get(labels.TPU_DEVICE_PLUGIN_CONFIG_LABEL) == \
            n.labels.get(DEVICE_PLUGIN_CONFIG_LABEL)
        assert {gpu_name(k): v for k, v in rn.status.allocatable.items()
                if k.startswith("google.com/")} == n.allocatable
        assert gpu_config(jload(self.rstore, node, CM)) == load_plugin_config(self.store, node, CM)
        rdev = JSliceClient(self.rstore, CM).get_devices(node)
        dev = SharedSliceClient(self.store, CM).get_devices(node)
        assert [(d.board_index, d.profile, d.status) for d in rdev] == \
            [(d.gpu_index, d.profile, d.status) for d in dev]
        return n


def node_geometries():
    return {0: {"8gb": 2}, 1: {"16gb": 1}}


# --------------------------------------------------- TestSharingPartitioner


def test_writes_the_config_map_and_flips_the_label():
    pair = Pair()
    pair.apply("shared-0", "plan-1", node_geometries())
    node = pair.check()
    cm = pair.store.get("ConfigMap", CM)
    assert list(cm.data) == ["shared-0-plan-1"]
    config = json.loads(cm.data["shared-0-plan-1"])
    assert {r["rename"]: r["replicas"] for r in config["sharing"]["resources"]} == {
        "nvidia.com/gpu-8gb": 2, "nvidia.com/gpu-16gb": 1}
    assert node.labels[DEVICE_PLUGIN_CONFIG_LABEL] == "shared-0-plan-1"


def test_supersedes_the_previous_plan_key():
    pair = Pair()
    pair.apply("shared-0", "plan-1", node_geometries())
    pair.apply("shared-0", "plan-2", node_geometries())
    pair.check()
    assert list(pair.store.get("ConfigMap", CM).data) == ["shared-0-plan-2"]


def test_other_nodes_keys_untouched():
    pair = Pair(names=("shared-0", "shared-1"))
    pair.apply("shared-0", "plan-1", node_geometries())
    pair.apply("shared-1", "plan-1", node_geometries())
    pair.check("shared-0")
    pair.check("shared-1")
    assert len(pair.store.get("ConfigMap", CM).data) == 2


def test_plugin_config_rendering():
    config = plugin_config_from_geometries(node_geometries())
    assert config["sharing"]["fail_requests_greater_than_one"] is True
    entry = config["sharing"]["resources"][0]
    assert entry == {"name": "nvidia.com/gpu", "rename": "nvidia.com/gpu-8gb",
                     "memory_gb": 8, "devices": [0], "replicas": 2}
    # MIG profiles and empty counts are not MPS entries
    assert plugin_config_from_geometries({0: {"3g.40gb": 1, "8gb": 0}})["sharing"][
        "resources"] == []


def test_prefix_named_nodes_keep_their_keys():
    pair = Pair(names=("pool-1", "pool-1-a"))
    pair.apply("pool-1-a", "1000-1", node_geometries())
    pair.apply("pool-1", "1000-2", node_geometries())
    pair.apply("pool-1", "1000-3", node_geometries())
    pair.check("pool-1")
    assert set(pair.store.get("ConfigMap", CM).data) == {"pool-1-a-1000-1", "pool-1-1000-3"}


# ------------------------------------------------ TestSimSharedDevicePlugin


def _actuated():
    pair = Pair()
    pair.apply("shared-0", "plan-1", node_geometries())
    pair.reconcile("shared-0")
    return pair


def test_advertises_the_mps_resources():
    pair = _actuated()
    alloc = pair.check().allocatable
    assert alloc["nvidia.com/gpu-8gb"] == 2 and alloc["nvidia.com/gpu-16gb"] == 1
    assert alloc[RESOURCE_GPU] == 2  # GPUs 0 and 1 shared, 2 of 4 whole


def test_a_missing_key_keeps_the_last_advertised_state():
    pair = _actuated()
    pair.rstore.patch_merge("ConfigMap", CM, "", lambda cm: cm.data.clear())
    pair.store.patch_merge("ConfigMap", CM, "", lambda cm: cm.data.clear())
    pair.reconcile("shared-0")
    alloc = pair.check().allocatable
    assert alloc["nvidia.com/gpu-8gb"] == 2 and alloc[RESOURCE_GPU] == 2


def test_a_payload_that_does_not_parse_is_no_config():
    pair = _actuated()
    pair.store.patch_merge("ConfigMap", CM, "",
                           lambda cm: cm.data.update({"shared-0-plan-1": "{"}))
    assert load_plugin_config(pair.store, "shared-0", CM) is None
    assert load_plugin_config(pair.store, "nowhere", CM) is None


# ------------------------------------ TestSharedSliceClientAndReporter


def test_slices_track_pod_usage_and_the_reporter_writes_them():
    pair = _actuated()
    pair.pod("user", 8)
    pair.check()
    devices = SharedSliceClient(pair.store, CM).get_devices("shared-0")
    assert [(d.gpu_index, d.profile, d.status) for d in devices] == [
        (0, "8gb", "used"), (0, "8gb", "free"), (1, "16gb", "free")]
    SharingReporter(pair.rstore, JSliceClient(pair.rstore, CM), "shared-0", 10.0).reconcile(
        Request(name="shared-0"))
    MpsReporter(pair.store, SharedSliceClient(pair.store, CM), "shared-0").reconcile()
    node = pair.check()
    assert {gpu_key(k): v for k, v in pair.rstore.get("Node", "shared-0").metadata
            .annotations.items()} == node.annotations
    _, status = annot.parse_node_annotations(node.annotations)
    assert {(s.gpu_index, s.profile, s.status): s.quantity for s in status} == {
        (0, "8gb", "used"): 1, (0, "8gb", "free"): 1, (1, "16gb", "free"): 1}


def test_the_reporter_refuses_a_mig_node():
    pair = Pair(names=("t0",), kind="tpu")
    SharingReporter(pair.rstore, JSliceClient(pair.rstore, CM), "t0", 10.0).reconcile(
        Request(name="t0"))
    MpsReporter(pair.store, SharedSliceClient(pair.store, CM), "t0").reconcile()
    assert pair.store.get("Node", "t0").annotations == {}
    assert jannot.parse_node_annotations(pair.rstore.get("Node", "t0").metadata.annotations) \
        == ([], [])


@pytest.mark.parametrize("seed", range(4))
def test_random_plans_and_pods_match_the_reference(seed):
    rng = random.Random(seed)
    pair = Pair(names=("shared-0", "shared-1"))
    rep = (SharingReporter(pair.rstore, JSliceClient(pair.rstore, CM), "shared-0", 10.0),
           MpsReporter(pair.store, SharedSliceClient(pair.store, CM), "shared-0"))
    pods = 0
    for plan in range(6):
        node = rng.choice(["shared-0", "shared-1"])
        geometries = {g: {f"{rng.choice([8, 10, 16, 20, 40])}gb": rng.randint(1, 3)
                          for _ in range(rng.randint(1, 2))}
                      for g in rng.sample(range(4), rng.randint(0, 3))}
        pair.apply(node, f"p{plan}", geometries)
        if rng.random() < 0.7:
            pair.reconcile(node)
        for _ in range(rng.randint(0, 2)):
            pods += 1
            pair.pod(f"u{pods}", rng.choice([8, 10, 16, 20, 40]), node="shared-0")
        rep[0].reconcile(Request(name="shared-0"))
        rep[1].reconcile()
        for n in ("shared-0", "shared-1"):
            pair.check(n)
        assert {gpu_key(k): v for k, v in pair.rstore.get("Node", "shared-0").metadata
                .annotations.items()} == pair.store.get("Node", "shared-0").annotations
