"""The annotation codec and the GPU nodes (nos_tpu_torch.gpu.annotations,
nos_tpu_torch.gpu.node) against nos_tpu's.

Exact, for this integer logic. The codec: a round trip, and parsing
against nos_tpu.api.v1alpha1.annotations on the same maps with the keys
translated (``-tpu-`` → ``-gpu-``, a topology → the MIG profile with as
many memory slices as it has chips). The nodes: MigNode against TpuNode
and MpsNode against SharingNode on seeded random states and request
sequences, built from translated inputs: the same allowed-geometry table
through both override hooks (as in test_torch_gpu_geometry.py), one
2x4 board (8 chips) per GPU, one shared chip per GPU with the GPU's 80 GB
budget on both sides.
"""
import dataclasses
import random

import pytest

from nos_tpu.api.v1alpha1 import annotations as jannot
from nos_tpu.api.v1alpha1 import constants, labels
from nos_tpu.kube.objects import Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec
from nos_tpu.tpu import known as jknown
from nos_tpu.tpu.node import TpuNode
from nos_tpu.tpu.sharing import SharingNode
from nos_tpu.tpu.topology import enumerate_tilings
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.gpu import known as tknown
from nos_tpu_torch.gpu.node import MigNode, MpsNode, mig_resource, mps_resource

V5E = "tpu-v5-lite-podslice"
H100 = tknown.H100_80GB
TO_MIG = {"1x1": "1g.10gb", "1x2": "2g.20gb", "2x2": "4g.40gb", "2x4": "7g.80gb"}
TO_TPU = {v: k for k, v in TO_MIG.items()}
GPU_LABELS = {tknown.GPU_PRODUCT_LABEL: H100}


def to_mig(g):
    return {TO_MIG[p]: n for p, n in g.items()}


def tpu_node(chips, annotations, kind="tpu"):
    alloc = {constants.RESOURCE_TPU: chips, "cpu": 8}
    return Node(
        metadata=ObjectMeta(name="n", labels={labels.GKE_TPU_ACCELERATOR_LABEL: V5E,
                                              labels.PARTITIONING_LABEL: kind},
                            annotations=dict(annotations)),
        status=NodeStatus(capacity=dict(alloc), allocatable=dict(alloc)))


def pod(requests):
    return Pod(metadata=ObjectMeta(name="p", namespace="ns"),
               spec=PodSpec(containers=[Container(requests=dict(requests))]))


def gpu_key(key, profile_map=TO_MIG):
    """A nos_tpu annotation key in the port's form."""
    for head in ("spec-tpu-", "status-tpu-"):
        if head in key:
            prefix, rest = key.split(head)
            index, tail = rest.split("-", 1)
            profile, _, status = tail.partition("-")
            profile = profile_map.get(profile, profile)
            return (prefix + head.replace("tpu", "gpu") + index + "-" + profile
                    + ("-" + status if status else ""))
    return key


@pytest.fixture
def same_tables():
    tilings = [dict(g) for g in enumerate_tilings("2x4", ("1x1", "1x2", "2x2", "2x4"))]
    jknown.set_known_geometries({V5E: tilings})
    tknown.set_known_geometries({H100: [to_mig(g) for g in tilings]})
    try:
        yield tilings
    finally:
        jknown.set_known_geometries(None)
        tknown.set_known_geometries(None)


# ------------------------------------------------------------------ codec


def test_annotation_keys_are_the_reference_nos_keys():
    assert tannot.SpecAnnotation(0, "1g.10gb", 2).key == "nos.nebuly.com/spec-gpu-0-1g.10gb"
    assert (tannot.StatusAnnotation(3, "20gb", "used", 1).key
            == "nos.nebuly.com/status-gpu-3-20gb-used")


@pytest.mark.parametrize("seed", range(4))
def test_annotation_round_trip(seed):
    rng = random.Random(seed)
    profiles = ["1g.10gb", "1g.20gb", "3g.40gb", "7g.80gb", "10gb", "26gb"]

    def geometries():
        return {i: {p: rng.randint(1, 4) for p in rng.sample(profiles, rng.randint(1, 3))}
                for i in rng.sample(range(4), rng.randint(1, 3))}

    spec = geometries()
    free, used = geometries(), geometries()
    annotations = {**tannot.spec_from_geometries(spec), **tannot.status_from_devices(free, used),
                   "other.io/key": "x"}
    parsed_spec, parsed_status = tannot.parse_node_annotations(annotations)
    assert tannot.spec_geometries(parsed_spec) == spec
    got_free = tannot.status_geometries([s for s in parsed_status if s.status == "free"])
    got_used = tannot.status_geometries([s for s in parsed_status if s.status == "used"])
    assert (got_free, got_used) == (free, used)
    assert all(annotations[s.key] == str(s.quantity) for s in parsed_spec + parsed_status)


@pytest.mark.parametrize("seed", range(4))
def test_annotation_parsing_matches_the_reference(seed):
    rng = random.Random(10 + seed)
    values = ["1", "3", "0", "-2", "x", "7"]
    keys = []
    for _ in range(25):
        head = rng.choice(["spec-tpu-", "status-tpu-", "spec-tpux-"])
        profile = rng.choice(["1x1", "1x2", "2x2", "2x4", "8gb", "x"])
        key = f"nos.nebuly.com/{head}{rng.randint(0, 3)}-{profile}"
        if head == "status-tpu-":
            key += rng.choice(["-free", "-used", "-gone"])
        keys.append(key)
    annotations = {k: rng.choice(values) for k in keys}
    j_spec, j_status = jannot.parse_node_annotations(annotations)
    t_spec, t_status = tannot.parse_node_annotations(
        {gpu_key(k): v for k, v in annotations.items()})
    as_mig = {**TO_MIG, "8gb": "8gb"}
    assert [(s.gpu_index, s.profile, s.quantity) for s in t_spec] == [
        (s.board_index, as_mig[s.profile], s.quantity) for s in j_spec]
    assert [(s.gpu_index, s.profile, s.status, s.quantity) for s in t_status] == [
        (s.board_index, as_mig[s.profile], s.status, s.quantity) for s in j_status]


# --------------------------------------------------------- MigNode / TpuNode


def _board_state(rng, tilings):
    base = dict(rng.choice(tilings))
    used = {p: k for p, n in base.items() if (k := rng.randint(0, n))}
    rest = {p: n - used.get(p, 0) for p, n in base.items()}
    free = {p: k for p, n in rest.items() if n > 0 and (k := rng.randint(0, n))}
    return free, used


def _slice_request(rng):
    return {f"google.com/tpu-slice-{p}": rng.randint(1, 2)
            for p in rng.sample(sorted(TO_MIG), rng.randint(1, 2))}


def _to_gpu_request(request):
    out = {}
    for name, qty in request.items():
        if name.startswith("google.com/tpu-slice-"):
            out[mig_resource(TO_MIG[name.rsplit("-", 1)[1]])] = qty
        elif name.startswith("google.com/tpu-mem-"):
            out[mps_resource(name.rsplit("-", 1)[1])] = qty
        else:
            out[name] = qty
    return out


@pytest.mark.parametrize("seed", range(6))
def test_mig_node_matches_tpu_node(same_tables, seed):
    rng = random.Random(200 + seed)
    for _ in range(25):
        gpus = rng.randint(1, 3)
        free, used = {}, {}
        for i in range(gpus):
            free[i], used[i] = _board_state(rng, same_tables)
        annotations = jannot.status_from_devices(free, used)
        if rng.random() < 0.1:  # a board the node does not have
            annotations[f"nos.nebuly.com/status-tpu-{gpus}-1x1-free"] = "1"
        tpu = TpuNode(tpu_node(8 * gpus, annotations))
        gpu = MigNode("n", GPU_LABELS, {"nvidia.com/gpu": gpus, "cpu": 8},
                      {gpu_key(k): v for k, v in annotations.items()})
        assert gpu.consistent == tpu.consistent
        for _ in range(6):
            request = _slice_request(rng)
            if rng.random() < 0.5:
                assert (gpu.update_geometry_for(_to_gpu_request(request))
                        == tpu.update_geometry_for(request))
            else:
                request["cpu"] = 1
                assert gpu.add_pod(_to_gpu_request(request)) == tpu.add_pod(pod(request))
            assert gpu.geometry() == {i: to_mig(g) for i, g in tpu.geometry().items()}
            assert gpu.free_slices() == to_mig(tpu.free_slices())
            assert gpu.scalar_resources() == _to_gpu_request(tpu.scalar_resources())


def test_mig_node_on_the_h100_table():
    annotations = tannot.status_from_devices({0: {"3g.40gb": 1}}, {0: {"4g.40gb": 1}})
    node = MigNode("n", GPU_LABELS, {"nvidia.com/gpu": 2}, annotations)
    assert node.geometry() == {0: {"3g.40gb": 1, "4g.40gb": 1}, 1: {}}
    assert node.update_geometry_for({mig_resource("1g.10gb"): 9})
    # GPU 0 keeps its used 4g.40gb and carves three; GPU 1 the six still
    # lacking, in the fewest-slices geometry that holds them
    assert node.gpus[0].used == {"4g.40gb": 1}
    assert node.geometry() == {0: {"4g.40gb": 1, "1g.10gb": 3},
                               1: {"1g.10gb": 6, "1g.20gb": 1}}
    assert node.add_pod({mig_resource("1g.10gb"): 9})
    assert not node.add_pod({mig_resource("1g.10gb"): 1})
    assert not node.add_pod({"nvidia.com/gpu": 1})  # whole GPUs: not a MIG slice
    assert node.add_pod({"cpu": 2})
    assert node.scalar_resources() == {mig_resource("4g.40gb"): 1,
                                       mig_resource("1g.10gb"): 9,
                                       mig_resource("1g.20gb"): 1}
    # another product, or no GPUs: nothing to model
    t4 = {tknown.GPU_PRODUCT_LABEL: "Tesla-T4"}
    assert MigNode("n", t4, {"nvidia.com/gpu": 1}, {}).gpus == []
    assert MigNode("n", GPU_LABELS, {}, {}).gpus == []
    # MPS annotations on a MIG node are not its own
    mixed = MigNode("n", GPU_LABELS, {"nvidia.com/gpu": 1},
                    tannot.status_from_devices({0: {"20gb": 2}}, {}))
    assert mixed.geometry() == {0: {}} and mixed.consistent


# ------------------------------------------------------- MpsNode / SharingNode


@pytest.fixture
def eighty_gb_chips(monkeypatch):
    spec = jknown.KNOWN_ACCELERATORS[V5E]
    monkeypatch.setitem(jknown.KNOWN_ACCELERATORS, V5E, dataclasses.replace(spec, hbm_gb=80))


@pytest.mark.parametrize("seed", range(6))
def test_mps_node_matches_sharing_node(eighty_gb_chips, seed):
    rng = random.Random(300 + seed)
    profiles = ["5gb", "10gb", "20gb", "26gb", "40gb"]
    for _ in range(25):
        gpus = rng.randint(1, 3)
        free, used = {}, {}
        for i in range(gpus):
            budget = 80
            for store in (used, free):
                g = store.setdefault(i, {})
                for p in rng.sample(profiles, rng.randint(0, 2)):
                    n = rng.randint(1, 2)
                    if int(p[:-2]) * n <= budget:
                        g[p] = n
                        budget -= int(p[:-2]) * n
        annotations = jannot.status_from_devices(free, used)
        if rng.random() < 0.1:
            annotations[f"nos.nebuly.com/status-tpu-{gpus}-10gb-free"] = "1"
        chips = SharingNode(tpu_node(gpus, annotations, kind="sharing"))
        node = MpsNode("n", GPU_LABELS, {"nvidia.com/gpu": gpus},
                       {gpu_key(k): v for k, v in annotations.items()})
        assert node.consistent == chips.consistent
        for _ in range(6):
            request = {f"google.com/tpu-mem-{p}": rng.randint(1, 3)
                       for p in rng.sample(profiles, rng.randint(1, 2))}
            if rng.random() < 0.5:
                assert (node.update_geometry_for(_to_gpu_request(request))
                        == chips.update_geometry_for(request))
            else:
                assert node.add_pod(_to_gpu_request(request)) == chips.add_pod(pod(request))
            assert node.geometry() == chips.geometry()
            assert node.free_slices() == chips.free_slices()
            assert node.scalar_resources() == _to_gpu_request(chips.scalar_resources())


def test_mps_node_carves_the_gpus_memory():
    node = MpsNode("n", GPU_LABELS, {"nvidia.com/gpu": 1}, {})
    assert node.update_geometry_for({mps_resource("26gb"): 3, mig_resource("1g.10gb"): 1})
    assert node.geometry() == {0: {"26gb": 3}}
    assert node.add_pod({mps_resource("26gb"): 3})
    assert not node.add_pod({mps_resource("26gb"): 1})
