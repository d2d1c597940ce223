"""The kubelet pod-resources client (nos_tpu_torch.device.podresources)
against nos_tpu.device.podresources.

- The wire decoder, exactly: random responses (hypothesis) serialized
  by the reference's generated ``podresources_pb2`` decode through the
  port's decoder to the same records; fields the reference's proto
  subset lacks (the kubelet's v1 API carries topology, CPU ids, memory)
  are skipped on both sides, whatever their wire type.
- Both clients against one in-process gRPC server on a unix socket (the
  fixture of tests/device/test_podresources.py): the same allocation,
  drawn from a seed, gives the same used ids, TPU resource names mapped
  to their GPU names (``google.com/tpu`` → ``nvidia.com/gpu``, a slice
  ``google.com/tpu-slice-<t>`` → ``nvidia.com/mig-<profile>``, a shared
  ``google.com/tpu-mem-<N>gb`` → ``nvidia.com/gpu-<N>gb``). The
  reference tracks plain chips and slices by default; the port also
  tracks MPS slices, so the reference is given the shared names too
  through its ``tracks`` argument.
"""
import concurrent.futures
import os
import random

import grpc
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nos_tpu.api.v1alpha1 import constants
from nos_tpu.device.podresources import KubeletPodResourcesClient as RefClient
from nos_tpu.device.proto import podresources_pb2 as pb
from nos_tpu_torch.device import podresources as tpr

TO_GPU = {"google.com/tpu": "nvidia.com/gpu",
          "google.com/tpu-slice-1x1": "nvidia.com/mig-1g.10gb",
          "google.com/tpu-slice-2x2": "nvidia.com/mig-4g.40gb",
          "google.com/tpu-slice-2x4": "nvidia.com/mig-7g.80gb",
          "google.com/tpu-mem-8gb": "nvidia.com/gpu-8gb",
          "google.com/tpu-mem-20gb": "nvidia.com/gpu-20gb",
          "example.com/fpga": "example.com/fpga"}  # foreign: ignored by both

_text = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=12)
_devices = st.lists(st.tuples(_text, st.lists(_text, max_size=4)), max_size=3)
_containers = st.lists(st.tuples(_text, _devices), max_size=3)
_pods = st.lists(st.tuples(_text, _text, _containers), max_size=4)


def ref_response(pods) -> "pb.ListPodResourcesResponse":
    response = pb.ListPodResourcesResponse()
    for name, namespace, containers in pods:
        pod = response.pod_resources.add()
        pod.name, pod.namespace = name, namespace
        for cname, devices in containers:
            container = pod.containers.add()
            container.name = cname
            for resource, ids in devices:
                device = container.devices.add()
                device.resource_name = resource
                device.device_ids.extend(ids)
    return response


def port_response(pods) -> tpr.ListPodResourcesResponse:
    return tpr.ListPodResourcesResponse([
        tpr.PodResources(name, namespace, [
            tpr.ContainerResources(cname, [tpr.ContainerDevices(r, list(ids))
                                           for r, ids in devices])
            for cname, devices in containers])
        for name, namespace, containers in pods])


@settings(max_examples=150, deadline=None)
@given(_pods)
def test_decoder_reads_what_the_generated_module_encodes(pods):
    wire = ref_response(pods).SerializeToString()
    assert tpr.ListPodResourcesResponse.decode(wire) == port_response(pods)
    assert pb.ListPodResourcesRequest.FromString(tpr.ListPodResourcesRequest().encode()) == \
        pb.ListPodResourcesRequest()


def _varint(n):
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(number, wire):
    return _varint(number << 3 | wire)


def _len(number, payload):
    return _tag(number, 2) + _varint(len(payload)) + payload


def _unknown_fields(number):
    """One field of each wire type, numbered from ``number``."""
    return (_tag(number, 0) + _varint(2**40 + 7)              # varint
            + _tag(number + 1, 1) + bytes(range(8))           # fixed64
            + _tag(number + 2, 5) + bytes(range(4))           # fixed32
            + _len(number + 3, b"\x08\x96\x01"))               # packed / message


def test_fields_the_subset_lacks_are_skipped():
    # ContainerDevices.topology (3), ContainerResources.cpu_ids (3) and
    # memory (4), and further numbers, as a newer kubelet sends them
    devices = pb.ContainerDevices(resource_name="nvidia.com/mig-3g.40gb",
                                  device_ids=["MIG-a", "MIG-b"]).SerializeToString()
    container = pb.ContainerResources(name="main").SerializeToString() \
        + _len(2, devices + _unknown_fields(3)) + _unknown_fields(3)
    pod = pb.PodResources(name="train", namespace="ml").SerializeToString() \
        + _len(3, container) + _unknown_fields(4)
    wire = _len(1, pod) + _unknown_fields(2)
    want = pb.ListPodResourcesResponse.FromString(wire)
    assert tpr.ListPodResourcesResponse.decode(wire) == port_response([
        (p.name, p.namespace, [(c.name, [(d.resource_name, list(d.device_ids))
                                         for d in c.devices]) for c in p.containers])
        for p in want.pod_resources]) == port_response(
        [("train", "ml", [("main", [("nvidia.com/mig-3g.40gb", ["MIG-a", "MIG-b"])])])])


def test_malformed_wire_raises():
    with pytest.raises(ValueError, match="truncated"):
        tpr.ListPodResourcesResponse.decode(b"\x0a\x05ab")
    with pytest.raises(ValueError, match="groups"):
        tpr.ListPodResourcesResponse.decode(_tag(1, 3))


# ------------------------------------------------------------ the clients


@pytest.fixture
def lister_server(tmp_path):
    """A gRPC server on a unix socket, answering with the reference's
    generated messages; yields (socket_path, set_response)."""
    state = {"response": pb.ListPodResourcesResponse()}

    def handle_list(request, context):
        return state["response"]

    service, method = tpr.LIST_METHOD.strip("/").rsplit("/", 1)
    handler = grpc.method_handlers_generic_handler(service, {
        method: grpc.unary_unary_rpc_method_handler(
            handle_list, request_deserializer=pb.ListPodResourcesRequest.FromString,
            response_serializer=pb.ListPodResourcesResponse.SerializeToString)})
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    socket_path = os.path.join(tmp_path, "kubelet.sock")
    server.add_insecure_port(f"unix://{socket_path}")
    server.start()
    yield socket_path, lambda r: state.update(response=r)
    server.stop(grace=None)


def _allocation(seed):
    """[(pod, namespace, [(container, [(TPU resource, ids)])])] with ids
    reused across containers (each counted once)."""
    rng = random.Random(seed)
    pods = []
    for p in range(rng.randint(0, 4)):
        containers = []
        for c in range(rng.randint(1, 3)):
            devices = [(rng.choice(sorted(TO_GPU)),
                        [f"dev-{rng.randint(0, 12)}" for _ in range(rng.randint(0, 3))])
                       for _ in range(rng.randint(0, 3))]
            containers.append((f"c{c}", devices))
        pods.append((f"pod{p}", "ml", containers))
    return pods


def _mapped(pods):
    return [(n, ns, [(c, [(TO_GPU[r], ids) for r, ids in devs]) for c, devs in cs])
            for n, ns, cs in pods]


@pytest.mark.parametrize("seed", range(6))
def test_both_clients_report_the_same_used_ids(lister_server, seed):
    socket_path, set_response = lister_server
    pods = _allocation(seed)
    ref = RefClient(socket_path=socket_path, timeout_seconds=5,
                    tracks=lambda r: r == constants.RESOURCE_TPU
                    or constants.is_tpu_slice_resource(r) or constants.is_tpu_shared_resource(r))
    port = tpr.KubeletPodResourcesClient(socket_path=socket_path, timeout_seconds=5)
    try:
        set_response(ref_response(pods))
        want = ref.get_used_device_ids("node")
        set_response(ref_response(_mapped(pods)))
        got = port.get_used_device_ids()
    finally:
        ref.close()
        port.close()
    assert got == want
    assert got == sorted({i for _, _, cs in pods for _, devs in cs for r, ids in devs
                          if r != "example.com/fpga" for i in ids})


def test_unreachable_socket_raises(tmp_path):
    client = tpr.KubeletPodResourcesClient(socket_path=os.path.join(tmp_path, "nope.sock"),
                                           timeout_seconds=0.5)
    try:
        with pytest.raises(grpc.RpcError):
            client.get_used_device_ids()
    finally:
        client.close()


def test_tracked_resources_are_nvidias():
    assert tpr.tracks_gpu("nvidia.com/gpu") and tpr.tracks_gpu("nvidia.com/mig-1g.10gb")
    assert tpr.tracks_gpu("nvidia.com/gpu-20gb")
    assert not tpr.tracks_gpu("google.com/tpu") and not tpr.tracks_gpu("example.com/fpga")

