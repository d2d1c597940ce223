"""The Kubernetes wire (nos_tpu_torch.kube.serde) against nos_tpu.kube.serde.

For objects of every kind drawn from a seed (``tests/torch_kube_cases.py``),
the port's ``to_wire`` equals the reference's on the counterpart object,
the port reads the reference's document back to the object it started
from (through JSON), and the reference reads the port's document to the
counterpart's own round trip. The flat model's deliberate differences
have a test each: a creation time to the whole second, folded
containers, the flat defaults of absent fields. The quantity codec and
``resource_path`` agree with the reference's on the reference's own cases.
"""
import json

import pytest

from nos_tpu.kube import serde as jserde
from nos_tpu_torch.kube import serde
from nos_tpu_torch.kube.objects import Pod
from tests.torch_kube_cases import KINDS, T0, draw, to_ref


def _json(doc):
    return json.loads(json.dumps(doc))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(8))
def test_to_wire_is_the_references_document_and_round_trips(kind, seed):
    obj = draw(seed, kind)
    doc = serde.to_wire(obj)
    assert doc == jserde.to_wire(to_ref(obj))
    assert serde.from_wire(_json(doc)) == obj
    ref_back = jserde.from_wire(_json(doc))
    assert jserde.to_wire(ref_back) == jserde.to_wire(jserde.from_wire(
        _json(jserde.to_wire(to_ref(obj)))))


def test_a_creation_time_goes_on_the_wire_to_the_whole_second():
    pod = Pod("p", created=T0 + 12.05)
    doc = serde.to_wire(pod)
    assert doc["metadata"]["creationTimestamp"] == jserde.to_wire(to_ref(pod))[
        "metadata"]["creationTimestamp"]
    assert serde.from_wire(doc).created == T0 + 12.0


def test_containers_fold_into_one_request_and_env():
    doc = {"kind": "Pod", "metadata": {"name": "p", "namespace": "ml"},
           "spec": {"containers": [
               {"name": "a", "resources": {"requests": {"nvidia.com/gpu": "1", "memory": "2Gi"}},
                "env": [{"name": "A", "value": "1"}, {"name": "S", "valueFrom": {}}]},
               {"name": "b", "resources": {"requests": {"nvidia.com/gpu": "2"}},
                "env": [{"name": "B", "value": "2"}]}],
               "initContainers": [{"name": "i"}], "priorityClassName": "high"},
           "status": {"phase": "Pending", "conditions": [
               {"type": "Ready", "status": "False"},
               {"type": "PodScheduled", "status": "False", "reason": "Unschedulable",
                "message": "no fit"}]}}
    pod = serde.from_wire(doc)
    assert pod.request == {"nvidia.com/gpu": 3, "memory": 2}
    assert pod.env == {"A": "1", "B": "2"}
    assert pod.unschedulable and pod.unschedulable_message == "no fit"
    # the flat defaults of absent fields
    assert pod.scheduler_name == "" and pod.created is None and pod.uid == ""
    ms = serde.from_wire({"kind": "ModelServing", "metadata": {"name": "m"}})
    assert ms.spec.slice_profile == "7g.80gb"
    assert jserde.from_wire({"kind": "ModelServing", "metadata": {"name": "m"}}
                            ).spec.slice_profile == "2x4"


@pytest.mark.parametrize("wire,value,memory", [
    ("8", 8.0, False), ("500m", 0.5, False), ("16Gi", 16.0, True), ("1G", 1e9 / 2**30, True),
    ("16384Mi", 16.0, True), (2 ** 31, 2.0, True), ("2k", 2000.0, False)])
def test_quantities_parse_as_the_reference(wire, value, memory):
    assert serde.parse_quantity(wire, memory=memory) == jserde.parse_quantity(wire, memory=memory)
    assert serde.parse_quantity(wire, memory=memory) == pytest.approx(value)


@pytest.mark.parametrize("name,value", [("nvidia.com/gpu", 8), ("memory", 16.0),
                                        ("memory", 0.5), ("cpu", 0.5),
                                        ("nos.nebuly.com/gpu-memory", 80)])
def test_quantities_format_as_the_reference(name, value):
    assert serde.format_quantity(name, value) == jserde.format_quantity(name, value)


def test_resource_paths_are_the_references():
    for kind in serde.RESOURCES:
        for ns, name in (("", ""), ("ml", ""), ("ml", "x")):
            assert serde.resource_path(kind, ns, name) == jserde.resource_path(kind, ns, name)
    assert serde.API_VERSIONS == jserde.API_VERSIONS
