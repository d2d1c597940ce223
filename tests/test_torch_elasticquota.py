"""The quota types, controller and webhooks (nos_tpu_torch.api.v1alpha1,
nos_tpu_torch.controllers.elasticquota) against nos_tpu's.

Exact, on translated cases (tests/torch_quota_cases.py): every test of
tests/controllers/test_elasticquota.py, built on both sides from one
description (quotas in ``nos.nebuly.com/gpu-memory`` GB or cpu, pods
asking for MIG slices where the reference's ask for chips, the
reference counting 10 GB a chip), held to the reference's labels,
``used``, deletions and admission verdicts. Then the port alone: the
memory aggregate of plain GPUs, the webhooks on a patch, the polled
controller, and the accounting order's one tolerated difference.
"""
import pytest

from nos_tpu.controllers.elasticquota import (
    CompositeElasticQuotaReconciler as JCompositeReconciler,
    ElasticQuotaReconciler as JReconciler,
    register_elasticquota_webhooks as jregister,
)
from nos_tpu.controllers.elasticquota.controller import sort_pods_for_quota as jsort
from nos_tpu.kube.controller import Request
from nos_tpu.kube.store import AdmissionError as JAdmissionError
from nos_tpu_torch.api.v1alpha1 import (
    CAPACITY_IN_QUOTA,
    CAPACITY_LABEL,
    CAPACITY_OVER_QUOTA,
    RESOURCE_GPU_MEMORY,
    ElasticQuota,
)
from nos_tpu_torch.controllers.elasticquota import (
    CompositeElasticQuotaReconciler,
    ElasticQuotaController,
    ElasticQuotaReconciler,
    register_elasticquota_webhooks,
    sort_pods_for_quota,
)
from nos_tpu_torch.kube.store import AdmissionError, NodeStore, Pod, PodPhase
from nos_tpu_torch.util import resources as res
from tests.torch_planner_cases import same_tables
from tests.torch_quota_cases import (
    CHIP_MEMORY_GB,
    GB,
    PodDesc,
    QuotaDesc,
    mig,
    mps,
    port_pod,
    port_quota,
    ref_pod,
    ref_quota,
    stores,
    to_port,
)


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


def reconcile_both(jstore, tstore, name="quota", ns="team-a", composite=False):
    if composite:
        JCompositeReconciler(jstore, chip_memory_gb=CHIP_MEMORY_GB).reconcile(
            Request(name=name, namespace=ns))
        CompositeElasticQuotaReconciler(tstore).reconcile(name, ns)
    else:
        JReconciler(jstore, chip_memory_gb=CHIP_MEMORY_GB).reconcile(
            Request(name=name, namespace=ns))
        ElasticQuotaReconciler(tstore).reconcile(name, ns)


def labels_both(jstore, tstore, name, ns):
    want = jstore.get("Pod", name, ns).metadata.labels.get(CAPACITY_LABEL)
    got = tstore.get("Pod", name, ns).labels.get(CAPACITY_LABEL)
    assert got == want
    return got


def used_both(jstore, tstore, kind="ElasticQuota", name="quota", ns="team-a"):
    want = to_port(jstore.get(kind, name, ns).status.used)
    got = tstore.get(kind, name, ns).used
    assert got == want
    return got


def running(name, request, ns="team-a", created=None):
    return PodDesc(name, request, ns=ns, phase="Running", created=created)


# ------------------------------------------------------------ reconciler

class TestElasticQuotaReconciler:
    def test_used_and_labels(self):
        # the reference's 8 and 4 chips: 80 and 40 GB
        jstore, tstore = stores(
            quotas=[QuotaDesc("team-a", min={GB: 80})],
            pods=[running("early", {mig("7g.80gb"): 1}, created=100.0),
                  running("late", {mig("4g.40gb"): 1}, created=110.0)])
        reconcile_both(jstore, tstore)
        assert labels_both(jstore, tstore, "early", "team-a") == CAPACITY_IN_QUOTA
        assert labels_both(jstore, tstore, "late", "team-a") == CAPACITY_OVER_QUOTA
        assert used_both(jstore, tstore) == {GB: 120}

    def test_only_min_resources_tracked(self):
        jstore, tstore = stores(quotas=[QuotaDesc("team-a", min={"cpu": 4})],
                                pods=[running("p", {"cpu": 2, "memory": 64})])
        reconcile_both(jstore, tstore)
        assert used_both(jstore, tstore) == {"cpu": 2}

    def test_pending_pods_not_counted(self):
        jstore, tstore = stores(quotas=[QuotaDesc("team-a", min={"cpu": 4})],
                                pods=[PodDesc("p", {"cpu": 2}, ns="team-a")])
        reconcile_both(jstore, tstore)
        assert used_both(jstore, tstore) == {}

    def test_label_flips_back_in_quota(self):
        jstore, tstore = stores(quotas=[QuotaDesc("team-a", min={"cpu": 2})],
                                pods=[running("a", {"cpu": 2}, created=100.0),
                                      running("b", {"cpu": 2}, created=105.0)])
        reconcile_both(jstore, tstore)
        assert labels_both(jstore, tstore, "b", "team-a") == CAPACITY_OVER_QUOTA
        jstore.delete("Pod", "a", "team-a")
        tstore.delete("Pod", "a", "team-a")
        reconcile_both(jstore, tstore)
        assert labels_both(jstore, tstore, "b", "team-a") == CAPACITY_IN_QUOTA


class TestCompositeElasticQuota:
    def test_accounts_across_namespaces(self):
        jstore, tstore = stores(
            quotas=[QuotaDesc("default", min={"cpu": 4}, name="composite",
                              namespaces=["a", "b"])],
            pods=[running("p1", {"cpu": 2}, ns="a", created=1.0),
                  running("p2", {"cpu": 3}, ns="b", created=2.0)])
        reconcile_both(jstore, tstore, name="composite", ns="default", composite=True)
        assert used_both(jstore, tstore, "CompositeElasticQuota", "composite",
                         "default") == {"cpu": 5}
        assert labels_both(jstore, tstore, "p1", "a") == CAPACITY_IN_QUOTA
        assert labels_both(jstore, tstore, "p2", "b") == CAPACITY_OVER_QUOTA

    def test_deletes_overlapping_eqs(self):
        jstore, tstore = stores(quotas=[
            QuotaDesc("a", min={"cpu": 1}, name="old"),
            QuotaDesc("default", min={"cpu": 4}, name="composite", namespaces=["a"])])
        reconcile_both(jstore, tstore, name="composite", ns="default", composite=True)
        assert jstore.try_get("ElasticQuota", "old", "a") is None
        assert tstore.try_get("ElasticQuota", "old", "a") is None


# ------------------------------------------------------------ webhooks

def admits_both(existing, new):
    """Whether each side's webhooks admit ``new`` after ``existing``; the
    two verdicts and the messages must agree."""
    from nos_tpu.kube.store import KubeStore

    jstore, tstore = KubeStore(), NodeStore()
    jregister(jstore)
    register_elasticquota_webhooks(tstore)
    for q in existing:
        jstore.create(ref_quota(q))
        tstore.create(port_quota(q))
    want = got = None
    try:
        jstore.create(ref_quota(new))
    except JAdmissionError as e:
        want = str(e)
    try:
        tstore.create(port_quota(new))
    except AdmissionError as e:
        got = str(e)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == want.replace("nos.nebuly.com/tpu-memory", GB)
    return got is None


class TestWebhooks:
    def test_one_eq_per_namespace(self):
        assert not admits_both([QuotaDesc("team-a", name="first")],
                               QuotaDesc("team-a", name="second"))

    def test_eq_rejected_in_ceq_namespace(self):
        assert not admits_both([QuotaDesc("default", name="composite",
                                          namespaces=["team-a"])],
                               QuotaDesc("team-a"))

    def test_ceq_overlap_rejected(self):
        assert not admits_both([QuotaDesc("default", name="c1", namespaces=["a", "b"])],
                               QuotaDesc("default", name="c2", namespaces=["b", "c"]))

    def test_min_above_max_rejected(self):
        assert not admits_both([], QuotaDesc("team-a", min={"cpu": 4}, max={"cpu": 2}))
        assert not admits_both([], QuotaDesc("team-a", min={GB: 40}, max={GB: 20}))

    def test_valid_quota_admitted(self):
        assert admits_both([], QuotaDesc("team-a", min={"cpu": 2}, max={"cpu": 4}))
        assert admits_both([], QuotaDesc("team-a", min={GB: 40}, max={GB: 80}))


# ------------------------------------------------------------ the port alone

def test_plain_gpu_counts_its_memory():
    """A plain nvidia.com/gpu counts the knob's GB (80, the H100's, by
    default); MIG and MPS slices count their own."""
    request = {"nvidia.com/gpu": 2, mig("3g.40gb"): 1, mig("1g.20gb"): 1,
               mps("5gb"): 3, "cpu": 4}
    assert res.gpu_memory_gb_in(request) == 2 * 80 + 40 + 20 + 15
    assert res.gpu_memory_gb_in(request, gpu_memory_gb=94) == 2 * 94 + 75
    assert res.with_aggregate_gpu_memory({"cpu": 1}) == {"cpu": 1}
    store = NodeStore()
    store.create(ElasticQuota("quota", "team-a", min={RESOURCE_GPU_MEMORY: 160}))
    for i, name in enumerate(("first", "second", "third")):
        store.create(Pod(name, "team-a", node="n", phase=PodPhase.RUNNING,
                         request={"nvidia.com/gpu": 1}, created=float(i)))
    ElasticQuotaController(store).step()
    assert store.get("ElasticQuota", "quota", "team-a").used == {RESOURCE_GPU_MEMORY: 240}
    assert [store.get("Pod", n, "team-a").labels[CAPACITY_LABEL]
            for n in ("first", "second", "third")] == [
        CAPACITY_IN_QUOTA, CAPACITY_IN_QUOTA, CAPACITY_OVER_QUOTA]
    ElasticQuotaController(store, gpu_memory_gb=40).step()
    assert store.get("ElasticQuota", "quota", "team-a").used == {RESOURCE_GPU_MEMORY: 120}


def test_webhooks_run_on_patches_too():
    store = NodeStore()
    register_elasticquota_webhooks(store)
    store.create(ElasticQuota("quota", "team-a", min={"cpu": 2}, max={"cpu": 4}))
    with pytest.raises(AdmissionError):
        store.patch_merge("ElasticQuota", "quota", "team-a",
                          lambda q: q.max.update(cpu=1))
    assert store.get("ElasticQuota", "quota", "team-a").max == {"cpu": 4}
    # the controller's own status write is admitted
    store.create(Pod("p", "team-a", node="n", phase=PodPhase.RUNNING, request={"cpu": 3}))
    ElasticQuotaController(store).step()
    assert store.get("ElasticQuota", "quota", "team-a").used == {"cpu": 3}


def test_controller_step_polls_every_quota_and_settles():
    store = NodeStore(clock=lambda: 7.0)
    store.create(ElasticQuota("old", "c", min={"cpu": 1}))
    store.create(ElasticQuota("quota", "d", min={"cpu": 2}))
    store.create(port_quota(QuotaDesc("default", min={"cpu": 3}, name="composite",
                                      namespaces=["a", "c"])))
    for name, ns, cpu in (("pa", "a", 2), ("pc", "c", 2), ("p1", "d", 1), ("p2", "d", 2)):
        store.create(Pod(name, ns, node="n", phase=PodPhase.RUNNING, request={"cpu": cpu}))
    controller = ElasticQuotaController(store)
    assert controller.step() > 0
    assert store.try_get("ElasticQuota", "old", "c") is None
    assert store.get("CompositeElasticQuota", "composite", "default").used == {"cpu": 4}
    assert store.get("ElasticQuota", "quota", "d").used == {"cpu": 3}
    assert store.get("Pod", "p1", "d").created == 7.0  # the store's clock
    assert controller.step() == 0  # nothing left to write


def test_sort_matches_the_reference_within_a_mode():
    """The accounting order: creation, priority, then the request summed
    with the memory aggregate. The reference's sum also counts a slice's
    chips, and its memory at its default 16 GB a chip, so a MIG pod
    weighs 1.7 times its GB there; the orders agree while pods tied on
    creation and priority are of one mode and their other requests differ
    by less than their GB do."""
    descs = [PodDesc(f"p{i}", req, ns="a", priority=prio, created=created)
             for i, (req, prio, created) in enumerate([
                 ({mig("7g.80gb"): 1}, 0, 5.0), ({mig("1g.10gb"): 2}, 0, 5.0),
                 ({mig("2g.20gb"): 1, "cpu": 3}, 0, 5.0), ({mig("4g.40gb"): 1}, 1, 5.0),
                 ({mig("1g.10gb"): 1}, 0, 4.0), ({mig("2g.20gb"): 1}, 0, 5.0)])]
    mps_descs = [PodDesc(f"s{i}", {mps(f"{gb}gb"): n, "cpu": c}, ns="b", created=1.0)
                 for i, (gb, n, c) in enumerate([(20, 1, 0), (10, 2, 1), (5, 4, 0), (40, 1, 2)])]
    for group in (descs, mps_descs):
        got = [p.name for p in sort_pods_for_quota([port_pod(d) for d in group])]
        want = [p.metadata.name for p in jsort([ref_pod(d) for d in group])]
        assert got == want


def test_sort_mig_and_mps_of_one_size_tie_in_the_port():
    """The tolerated difference (ROADMAP.md): a 2g.20gb and a 20 GB MPS
    slice created together at one priority sum to the same size in the
    port, so the name decides; the reference weighs the MIG slice's chips
    too and puts the MPS pod first."""
    descs = [PodDesc("a-mig", {mig("2g.20gb"): 1}, ns="a", created=1.0),
             PodDesc("b-mps", {mps("20gb"): 1}, ns="a", created=1.0)]
    got = [p.name for p in sort_pods_for_quota([port_pod(d) for d in descs])]
    want = [p.metadata.name for p in jsort([ref_pod(d) for d in descs])]
    assert got == ["a-mig", "b-mps"] and want == ["b-mps", "a-mig"]
