"""The node store (nos_tpu_torch.kube.store) against nos_tpu.kube.store.

Seeded random sequences of the verbs the agents and partitioners call
(create, get / try_get, delete, list of pods, patch_annotations and
patch_labels with deletions, patch_merge) run on both stores, the
reference's kube objects built from the same plain values; after every
operation the nodes' labels, capacity, allocatable and annotations, the
pods (namespace, name, node, phase, request) and the config maps' data
agree exactly, and so do the errors (missing objects, duplicates).
"""
import random

import pytest

from nos_tpu.kube import store as jstore
from nos_tpu.kube.objects import ConfigMap as JConfigMap
from nos_tpu.kube.objects import ObjectMeta
from nos_tpu.kube.objects import PodPhase as JPodPhase
from nos_tpu_torch.kube.store import (
    AlreadyExistsError,
    ConfigMap,
    Node,
    NodeStore,
    NotFoundError,
    Pod,
    PodPhase,
)
from tests.factory import build_node, build_pod


def views(ref, port):
    """(reference, port) as plain values."""
    r_nodes = {n.metadata.name: (n.metadata.labels, n.status.capacity, n.status.allocatable,
                                 n.metadata.annotations) for n in ref.list("Node")}
    p_nodes = {n.name: (n.labels, n.capacity, n.allocatable, n.annotations)
               for n in port.list("Node")}
    r_pods = [(p.metadata.namespace, p.metadata.name, p.spec.node_name, p.status.phase,
               p.spec.containers[0].requests) for p in ref.list("Pod")]
    p_pods = [(p.namespace, p.name, p.node, p.phase, p.request) for p in port.list("Pod")]
    r_cms = {c.metadata.name: c.data for c in ref.list("ConfigMap")}
    p_cms = {c.name: c.data for c in port.list("ConfigMap")}
    return (r_nodes, sorted(r_pods), r_cms), (p_nodes, sorted(p_pods), p_cms)


def both(fn_ref, fn_port):
    """Run one operation on each side; the same outcome or the same
    error kind."""
    errors = []
    for fn in (fn_ref, fn_port):
        try:
            fn()
            errors.append(None)
        except (jstore.NotFoundError, NotFoundError):
            errors.append("missing")
        except (jstore.AlreadyExistsError, AlreadyExistsError):
            errors.append("exists")
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", range(6))
def test_random_operations_match_the_reference(seed):
    rng = random.Random(seed)
    ref, port = jstore.KubeStore(), NodeStore()
    names = ["n1", "n2", "n3"]
    keys = ["nos.nebuly.com/a", "nos.nebuly.com/b", "c", "d"]
    for step in range(120):
        op = rng.randrange(8)
        name = rng.choice(names)
        if op == 0:
            cap = {"nvidia.com/gpu": rng.randint(1, 8)}
            both(lambda: ref.create(build_node(name, dict(cap))),
                 lambda: port.create(Node(name, capacity=dict(cap), allocatable=dict(cap))))
        elif op == 1:
            patch = {k: rng.choice([None, str(rng.randint(0, 9))]) for k in
                     rng.sample(keys, rng.randint(1, 3))}
            both(lambda: ref.patch_annotations("Node", name, "", patch),
                 lambda: port.patch_annotations("Node", name, "", patch))
        elif op == 2:
            patch = {k: rng.choice([None, "mig", "mps"]) for k in rng.sample(keys, 2)}
            both(lambda: ref.patch_labels("Node", name, "", patch),
                 lambda: port.patch_labels("Node", name, "", patch))
        elif op == 3:
            gpus = rng.randint(0, 4)

            def rmut(n):
                n.status.allocatable["nvidia.com/gpu"] = gpus

            def pmut(n):
                n.allocatable["nvidia.com/gpu"] = gpus

            both(lambda: ref.patch_merge("Node", name, "", rmut),
                 lambda: port.patch_merge("Node", name, "", pmut))
        elif op == 4:
            pod, ns = f"p{rng.randint(0, 5)}", rng.choice(["ml", "default"])
            req = {"nvidia.com/mig-3g.40gb": rng.randint(1, 2)}
            phase = rng.choice([JPodPhase.PENDING, JPodPhase.RUNNING])
            both(lambda: ref.create(build_pod(pod, req, ns=ns, node=name, phase=phase)),
                 lambda: port.create(Pod(pod, ns, name, phase, dict(req))))
        elif op == 5:
            pod, ns = f"p{rng.randint(0, 5)}", rng.choice(["ml", "default"])
            both(lambda: ref.delete("Pod", pod, ns), lambda: port.delete("Pod", pod, ns))
        elif op == 6:
            key, value = rng.choice(keys), str(step)

            def rcm(cm):
                cm.data[key] = value

            def pcm(cm):
                cm.data[key] = value

            if rng.random() < 0.3:
                both(lambda: ref.create(JConfigMap(metadata=ObjectMeta(name="cm"),
                                                   data={key: value})),
                     lambda: port.create(ConfigMap("cm", "", {key: value})))
            else:
                both(lambda: ref.patch_merge("ConfigMap", "cm", "", rcm),
                     lambda: port.patch_merge("ConfigMap", "cm", "", pcm))
        else:
            both(lambda: ref.get("Node", name), lambda: port.get("Node", name))
            assert (ref.try_get("Node", name) is None) == (port.try_get("Node", name) is None)
        want, got = views(ref, port)
        assert got == want


def test_returned_objects_are_copies():
    store = NodeStore()
    store.create(Node("n", annotations={"a": "1"}))
    node = store.get("Node", "n")
    node.annotations["a"] = "2"
    assert store.get("Node", "n").annotations == {"a": "1"}
    patched = store.patch_annotations("Node", "n", "", {"b": "x"})
    patched.annotations.clear()
    assert store.get("Node", "n").annotations == {"a": "1", "b": "x"}
    store.create(Pod("p", request={"nvidia.com/gpu": 1}))
    store.list("Pod")[0].request.clear()
    assert store.get("Pod", "p", "default").request == {"nvidia.com/gpu": 1}
    with pytest.raises(TypeError):
        store.create(object())
    assert PodPhase.RUNNING == JPodPhase.RUNNING and PodPhase.PENDING == JPodPhase.PENDING


def test_create_stamps_a_fresh_uid_and_the_creation_time():
    clock = [3.0]
    store = NodeStore(clock=lambda: clock[0])
    first = store.create(Pod("p", uid="mine"))
    assert first.uid and first.uid != "mine" and first.created == 3.0
    store.delete("Pod", "p", "default")
    clock[0] = 9.0
    again = store.create(Pod("p"))
    assert again.uid != first.uid and again.created == 9.0
    # a creation time the caller set is kept
    assert store.create(Pod("q", created=1.5)).created == 1.5
    # nodes carry neither
    assert not hasattr(store.create(Node("n")), "uid")


def test_admission_refuses_a_create_and_a_patch():
    from nos_tpu_torch.api.v1alpha1 import ElasticQuota
    from nos_tpu_torch.kube.store import AdmissionError

    store = NodeStore()
    seen = []

    def no_big_min(quota, s):
        seen.append((quota.name, s is store))
        if quota.min.get("cpu", 0) > 8:
            raise AdmissionError("min too large")

    store.register_admission("ElasticQuota", no_big_min)
    store.create(ElasticQuota("q", "a", min={"cpu": 2}))
    with pytest.raises(AdmissionError):
        store.create(ElasticQuota("r", "a", min={"cpu": 9}))
    with pytest.raises(AdmissionError):
        store.patch_merge("ElasticQuota", "q", "a", lambda q: q.min.update(cpu=10))
    assert store.get("ElasticQuota", "q", "a").min == {"cpu": 2}
    assert store.try_get("ElasticQuota", "r", "a") is None
    assert seen == [("q", True), ("r", True), ("q", True)]
    store.create(Pod("p"))  # other kinds are not refused


def test_list_by_namespace_without_copies_and_the_revision():
    store = NodeStore()
    assert store.revision == 0
    for ns, name in (("b", "p"), ("a", "q"), ("a", "p")):
        store.create(Pod(name, ns))
    assert store.revision == 3
    assert [p.namespaced_name for p in store.list("Pod", namespace="a")] == ["a/p", "a/q"]
    shared = store.list("Pod", copy=False)
    assert shared[0] is store.list("Pod", copy=False)[0]
    assert store.list("Pod")[0] is not shared[0]
    # a write stores a new object: what was listed stays as it was
    store.patch_labels("Pod", "p", "a", {"x": "1"})
    assert shared[0].labels == {} and store.get("Pod", "p", "a").labels == {"x": "1"}
    store.delete("Pod", "p", "b")
    assert store.revision == 5
    with pytest.raises(NotFoundError):
        store.delete("Pod", "p", "b")
    assert store.revision == 5
