"""The kubelet's pod-resources client: counterpart of
``nos_tpu/device/podresources.py:38`` (``KubeletPodResourcesClient``).

The reference nos learns which devices pods hold from the kubelet itself
(pkg/resource/client.go:40-87 dials the pod-resources unix socket,
pkg/resource/lister.go:30-38 maps ``List()``'s answer to used device
ids). Here the tracked resources are NVIDIA's: whole GPUs
(``nvidia.com/gpu``), MIG instances (``nvidia.com/mig-<profile>``) and
MPS slices (``nvidia.com/gpu-<N>gb``). The NVIDIA device plugin lists a
MIG device by its ``MIG-<uuid>``, the id ``GpuClient.get_devices``
matches against NVML's. The client follows the port's
``PodResourcesClient`` protocol (``device/client.py``).

``grpc`` is imported in the constructor, never at import: the card's
machine promises neither ``grpc`` nor ``protobuf``. The messages of
``/v1.PodResourcesLister/List`` (the subset in
``nos_tpu/device/proto/podresources.proto``) go through a small
hand-written protobuf wire decoder (varint tags, length-delimited
strings and messages; the request has no fields, so it encodes to no
bytes) in the place of the reference's generated ``podresources_pb2``, which would register ``podresources.proto`` a
second time in protobuf's default pool. Fields the subset lacks (the
kubelet's v1 API carries topology, CPU ids, memory, dynamic resources)
are skipped, as protobuf skips unknown fields.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

DEFAULT_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
LIST_METHOD = "/v1.PodResourcesLister/List"

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


# -------------------------------------------------------- wire decoder


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, bytes]]:
    """(field number, payload) of every length-delimited field of a
    message; fields of any other wire type are skipped."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            _, pos = _read_varint(buf, pos)
        elif wire == _I64:
            pos += 8
        elif wire == _I32:
            pos += 4
        elif wire == _LEN:
            size, pos = _read_varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated length-delimited field")
            yield number, buf[pos:pos + size]
            pos += size
        else:
            raise ValueError(f"wire type {wire} (groups) is not used by this API")
        if pos > len(buf):
            raise ValueError("truncated field")


@dataclass
class ContainerDevices:
    resource_name: str = ""                                 # 1
    device_ids: List[str] = field(default_factory=list)     # 2, repeated

    @classmethod
    def decode(cls, buf: bytes) -> "ContainerDevices":
        out = cls()
        for number, payload in _fields(buf):
            if number == 1:
                out.resource_name = payload.decode()
            elif number == 2:
                out.device_ids.append(payload.decode())
        return out


@dataclass
class ContainerResources:
    name: str = ""                                                # 1
    devices: List[ContainerDevices] = field(default_factory=list)  # 2, repeated

    @classmethod
    def decode(cls, buf: bytes) -> "ContainerResources":
        out = cls()
        for number, payload in _fields(buf):
            if number == 1:
                out.name = payload.decode()
            elif number == 2:
                out.devices.append(ContainerDevices.decode(payload))
        return out


@dataclass
class PodResources:
    name: str = ""                                                     # 1
    namespace: str = ""                                                # 2
    containers: List[ContainerResources] = field(default_factory=list)  # 3, repeated

    @classmethod
    def decode(cls, buf: bytes) -> "PodResources":
        out = cls()
        for number, payload in _fields(buf):
            if number == 1:
                out.name = payload.decode()
            elif number == 2:
                out.namespace = payload.decode()
            elif number == 3:
                out.containers.append(ContainerResources.decode(payload))
        return out


@dataclass
class ListPodResourcesResponse:
    pod_resources: List[PodResources] = field(default_factory=list)  # 1, repeated

    @classmethod
    def decode(cls, buf: bytes) -> "ListPodResourcesResponse":
        return cls([PodResources.decode(p) for n, p in _fields(buf) if n == 1])


@dataclass
class ListPodResourcesRequest:
    def encode(self) -> bytes:
        return b""  # no fields


# --------------------------------------------------------------- client


def tracks_gpu(resource_name: str) -> bool:
    """NVIDIA device-plugin resources: whole GPUs, MIG instances and MPS
    slices."""
    from nos_tpu_torch.gpu.node import MIG_RESOURCE_PREFIX, MPS_RESOURCE_PREFIX, RESOURCE_GPU

    return (resource_name == RESOURCE_GPU or resource_name.startswith(MIG_RESOURCE_PREFIX)
            or resource_name.startswith(MPS_RESOURCE_PREFIX))


class KubeletPodResourcesClient:
    """gRPC client over the kubelet's node-local pod-resources socket."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET, timeout_seconds: float = 10.0) -> None:
        import grpc

        self.timeout = timeout_seconds
        self._channel = grpc.insecure_channel(f"unix://{socket_path}")
        self._list = self._channel.unary_unary(
            LIST_METHOD,
            request_serializer=ListPodResourcesRequest.encode,
            response_deserializer=ListPodResourcesResponse.decode,
        )

    def close(self) -> None:
        self._channel.close()

    def list_pod_resources(self) -> ListPodResourcesResponse:
        return self._list(ListPodResourcesRequest(), timeout=self.timeout)

    def get_used_device_ids(self) -> List[str]:
        """Ids of the tracked devices allocated to pods on this node (the
        kubelet is node-local), sorted, each once."""
        used = set()
        for pod in self.list_pod_resources().pod_resources:
            for container in pod.containers:
                for device in container.devices:
                    if tracks_gpu(device.resource_name):
                        used.update(device.device_ids)
        return sorted(used)
