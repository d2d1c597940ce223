"""The admission webhook server against the reference's.

The same AdmissionReviews, posted over TLS to the port's
``build_elasticquota_webhook_server`` and to the reference's, on stores
holding the same translated quotas and nodes: quota creates and updates,
allowed and refused (one ElasticQuota a namespace, none under a
CompositeElasticQuota, no overlapping composites, min <= max), an object
that does not decode, and the oversized-pod mutation on
``/mutate-v1-pod``. Both give the same ``allowed``, the same message
(resource names translated, and the reference's float quantities
written as the integers they are), and the same JSONPatch under the
translation: the gang labels, the rank-0 env, the hostname and subdomain
and the fields the flat pod does not model are the same; the request is
each side's member share (one 2x4 board a host in the reference, eight
whole-GPU instances a node here) and the shape annotation its topology.
"""
import base64
import copy
import json
import re
import ssl
import urllib.request

import pytest

from nos_tpu.api.v1alpha1 import elasticquota as jeq
from nos_tpu.kube import objects as jobj
from nos_tpu.kube import serde as jserde
from nos_tpu.kube.store import KubeStore
from nos_tpu.kube.webhook import build_elasticquota_webhook_server as j_build_server
from nos_tpu_torch.api.v1alpha1.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.controllers.elasticquota import register_elasticquota_webhooks
from nos_tpu_torch.kube import serde as tserde
from nos_tpu_torch.kube import store as tstore
from nos_tpu_torch.kube.webhook import (
    PATH_COMPOSITEELASTICQUOTA,
    PATH_ELASTICQUOTA,
    PATH_MUTATE_POD,
    build_elasticquota_webhook_server,
    generate_self_signed_cert,
)
from torch_planner_cases import NodeDesc, port_node, ref_node, to_ref_resource, translate_text

GB = "nos.nebuly.com/gpu-memory"


def _ref_eq(q):
    return jeq.ElasticQuota(metadata=jobj.ObjectMeta(name=q.name, namespace=q.namespace),
                            spec=jeq.ElasticQuotaSpec(
                                {to_ref_resource(k): v for k, v in q.min.items()},
                                {to_ref_resource(k): v for k, v in q.max.items()}))


def _ref_ceq(q):
    return jeq.CompositeElasticQuota(
        metadata=jobj.ObjectMeta(name=q.name, namespace=q.namespace),
        spec=jeq.CompositeElasticQuotaSpec(list(q.namespaces),
                                           {to_ref_resource(k): v for k, v in q.min.items()},
                                           {to_ref_resource(k): v for k, v in q.max.items()}))


def _ref(obj):
    return _ref_ceq(obj) if obj.kind == "CompositeElasticQuota" else _ref_eq(obj)


STORED = [ElasticQuota("quota", "team-a", {GB: 80}, {GB: 160}),
          CompositeElasticQuota("shared", "default", ["team-b", "team-c"], {GB: 160})]


@pytest.fixture(scope="module")
def servers():
    cert, key = generate_self_signed_cert()
    tstore_, jstore = tstore.NodeStore(), KubeStore()
    register_elasticquota_webhooks(tstore_)
    for obj in STORED:
        tstore_.create(obj)
        jstore.create(_ref(obj))
    for i in range(2):
        desc = NodeDesc(f"gpu-{i}", gpus=8)
        tstore_.create(port_node(desc))
        jstore.create(ref_node(desc))
    port = build_elasticquota_webhook_server(tstore_, port=0, host="127.0.0.1",
                                             cert_pem=cert, key_pem=key).start()
    ref = j_build_server(jstore, port=0, host="127.0.0.1")
    ref.start()
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    yield port, ref, ctx
    port.stop()
    ref.stop()


def _post(server, ctx, path, obj_wire, uid="u-1"):
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": uid, "object": obj_wire}}
    req = urllib.request.Request(f"https://127.0.0.1:{server.port}{path}",
                                 data=json.dumps(review).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
        return json.load(resp)["response"]


QUOTA_CASES = [
    ("eq_create_allowed", ElasticQuota("quota", "team-d", {GB: 80}, {GB: 160})),
    ("eq_update_allowed", ElasticQuota("quota", "team-a", {GB: 40})),
    ("eq_second_in_namespace", ElasticQuota("other", "team-a", {GB: 10})),
    ("eq_under_composite", ElasticQuota("quota", "team-b", {GB: 10})),
    ("eq_max_below_min", ElasticQuota("quota", "team-e", {GB: 160}, {GB: 80})),
    ("ceq_create_allowed", CompositeElasticQuota("new", "default", ["team-x"], {GB: 80})),
    ("ceq_update_allowed", CompositeElasticQuota("shared", "default", ["team-b"], {GB: 80})),
    ("ceq_overlap", CompositeElasticQuota("new", "default", ["team-c", "team-y"], {GB: 80})),
    ("ceq_max_below_min", CompositeElasticQuota("new", "default", ["team-z"], {GB: 80},
                                                {GB: 40})),
]


@pytest.mark.parametrize("case,obj", QUOTA_CASES, ids=[c[0] for c in QUOTA_CASES])
def test_quota_reviews_agree(servers, case, obj):
    port, ref, ctx = servers
    path = PATH_COMPOSITEELASTICQUOTA if obj.kind == "CompositeElasticQuota" else \
        PATH_ELASTICQUOTA
    got = _post(port, ctx, path, tserde.to_wire(obj))
    want = _post(ref, ctx, path, jserde.to_wire(_ref(obj)))
    assert got["uid"] == want["uid"] == "u-1"
    assert got["allowed"] == want["allowed"] == case.endswith("allowed")
    if not want["allowed"]:
        assert got["status"]["code"] == want["status"]["code"] == 403
        # the reference's wire decodes quantities as floats (80.0)
        want_message = re.sub(r"(\d+)\.0\b", r"\1", translate_text(want["status"]["message"]))
        assert got["status"]["message"] == want_message


def test_an_object_that_does_not_decode_is_denied(servers):
    port, ref, ctx = servers
    bad = {"kind": "ElasticQuota", "metadata": {"name": "q", "namespace": "x"},
           "spec": {"min": {GB: "not-a-quantity"}}}
    got, want = _post(port, ctx, PATH_ELASTICQUOTA, bad), _post(ref, ctx, PATH_ELASTICQUOTA, bad)
    assert got["allowed"] is want["allowed"] is False
    assert got["status"]["code"] == want["status"]["code"] == 400
    assert got["status"]["message"].startswith("webhook error:")
    assert want["status"]["message"].startswith("webhook error:")


def _with_unmodelled_fields(wire):
    wire = copy.deepcopy(wire)
    wire["spec"]["serviceAccountName"] = "trainer"
    wire["spec"]["containers"][0]["volumeMounts"] = [{"name": "data", "mountPath": "/data"}]
    wire["spec"]["containers"][0]["env"] = [{"name": "RUN", "value": "7"}]
    return wire


def _patch(response):
    assert response["allowed"] is True and response["patchType"] == "JSONPatch"
    return {op["path"]: (op["op"], op["value"])
            for op in json.loads(base64.b64decode(response["patch"]))}


def test_the_oversized_pod_mutation_agrees(servers):
    port, ref, ctx = servers
    tpod = tstore.Pod("train", "team-b", request={"nvidia.com/gpu": 16},
                      scheduler_name="nos-scheduler", labels={"app": "llm"})
    jpod = jobj.Pod(metadata=jobj.ObjectMeta(name="train", namespace="team-b",
                                             labels={"app": "llm"}),
                    spec=jobj.PodSpec(containers=[jobj.Container(
                        name="main", requests={"google.com/tpu": 16},
                        limits={"google.com/tpu": 16})], scheduler_name="nos-scheduler"))
    got = _patch(_post(port, ctx, PATH_MUTATE_POD, _with_unmodelled_fields(
        tserde.pod_to_wire(tpod))))
    want = _patch(_post(ref, ctx, PATH_MUTATE_POD, _with_unmodelled_fields(
        jserde.pod_to_wire(jpod))))
    assert set(got) == set(want) == {"/metadata/labels", "/metadata/annotations",
                                     "/spec/containers", "/spec/hostname", "/spec/subdomain"}
    assert {p: op for p, (op, _) in got.items()} == {p: op for p, (op, _) in want.items()}
    assert got["/metadata/labels"] == want["/metadata/labels"]
    assert got["/metadata/labels"][1]["nos.nebuly.com/gang-size"] == "2"
    assert set(got["/metadata/annotations"][1]) == set(want["/metadata/annotations"][1])
    assert got["/spec/hostname"] == want["/spec/hostname"] == ("add", "train")
    assert got["/spec/subdomain"] == want["/spec/subdomain"] == ("add", "train")
    (tc,), (jc,) = got["/spec/containers"][1], want["/spec/containers"][1]
    assert tc["env"] == jc["env"]  # RUN kept, then rank 0's coordinates
    assert tc["volumeMounts"] == jc["volumeMounts"]
    # each side's member share: eight whole-GPU instances, one 2x4 board
    assert tc["resources"]["requests"] == {"nvidia.com/mig-7g.80gb": "8"}
    assert jc["resources"]["requests"] == {"google.com/tpu-slice-2x4": "1"}
    # a pod that fits one node needs no patch on either side
    small = tserde.pod_to_wire(tstore.Pod("small", "team-b", request={"nvidia.com/gpu": 2}))
    assert "patch" not in _post(port, ctx, PATH_MUTATE_POD, small)
