"""The capacity ledger's accounting core (nos_tpu_torch.capacity)
against nos_tpu.capacity.ledger.

The same writes go to both stores under the parity translation (a v5e
node of 8 chips is a MIG node of one H100, 80 GB; a 1x1 / 1x2 / 2x2 /
2x4 slice a 1g.10gb / 2g.20gb / 4g.40gb / 7g.80gb instance, 10 GB a
chip; the reference's ``tpu`` partitioning is the port's ``mig``), and
the ledgers observe at the same integer instants, so every product is
exact: the port's GB-seconds must equal the reference's chip-seconds x
10 exactly, in every total, bucket, reason, pool and namespace. The
cases are tests/capacity/test_ledger.py's on the ported core, then
random write sequences; ``self_check`` stays clean on the port.
"""
import itertools
import random

import pytest

from nos_tpu.api.v1alpha1 import constants as jconstants
from nos_tpu.api.v1alpha1 import elasticquota as jeq
from nos_tpu.capacity.ledger import CapacityLedger as JLedger
from nos_tpu.kube import objects as jobj
from nos_tpu.kube.store import KubeStore
from nos_tpu.scheduler.plugins.gang import GANG_NAME_LABEL as J_GANG_NAME
from nos_tpu.scheduler.plugins.gang import GANG_SIZE_LABEL as J_GANG_SIZE
from nos_tpu_torch.api.v1alpha1 import ElasticQuota, RESOURCE_GPU_MEMORY
from nos_tpu_torch.capacity import (
    BUCKET_AUTOSCALER,
    BUCKET_NO_DEMAND,
    BUCKET_PENDING,
    BUCKET_RECONFIG,
    BUCKET_RESERVED,
    CapacityLedger,
    dominant_unserved_reason,
    state_from_store,
)
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.kube.store import NodeStore, Pod, PodPhase
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from tests.factory import build_pod, build_tpu_node
from tests.torch_planner_cases import TO_TPU, NodeDesc, port_node

T0 = 1_000_000.0
CHIPS = {"1g.10gb": 1, "2g.20gb": 2, "4g.40gb": 4, "7g.80gb": 8}
SPEC_PLAN, STATUS_PLAN = tannot.SPEC_PARTITIONING_PLAN, tannot.STATUS_PARTITIONING_PLAN
RESERVED_FOR = tannot.PREFIX + "reserved-for"
GRACE = (tannot.AUTOSCALER_RESERVED, tannot.AUTOSCALER_RESERVED_UNTIL)


class Both:
    """One ledger on each store; every write goes to both."""

    def __init__(self):
        self.jstore, self.tstore = KubeStore(), NodeStore()
        self.jledger = JLedger(self.jstore, metrics=False)
        self.tledger = CapacityLedger(self.tstore, metrics=False)

    def node(self, name, gpus=1, annotations=None):
        topology = "2x4" if gpus == 1 else "4x4"
        self.jstore.create(build_tpu_node(name=name, chips=8 * gpus, topology=topology,
                                          annotations=dict(annotations or {})))
        self.tstore.create(port_node(NodeDesc(name, gpus=gpus,
                                              annotations=dict(annotations or {}))))

    def annotate(self, name, patch):
        self.jstore.patch_annotations("Node", name, "", patch)
        self.tstore.patch_annotations("Node", name, "", patch)

    def pod(self, name, profile="4g.40gb", ns="default", node="", phase="Pending", gang=None):
        jpod = build_pod(name, {jconstants.tpu_slice_resource(TO_TPU[profile]): 1}, ns=ns,
                         node=node, phase=phase)
        tpod = Pod(name, ns, node=node, phase=phase, request={f"nvidia.com/mig-{profile}": 1})
        if gang is not None:
            jpod.metadata.labels.update({J_GANG_NAME: gang[0], J_GANG_SIZE: str(gang[1])})
            tpod.labels.update({GANG_NAME_LABEL: gang[0], GANG_SIZE_LABEL: str(gang[1])})
        self.jstore.create(jpod)
        self.tstore.create(tpod)

    def set_pod(self, name, ns="default", node=None, phase=None):
        def jmutate(p):
            if node is not None:
                p.spec.node_name = node
            if phase is not None:
                p.status.phase = phase

        def tmutate(p):
            if node is not None:
                p.node = node
            if phase is not None:
                p.phase = phase

        self.jstore.patch_merge("Pod", name, ns, jmutate)
        self.tstore.patch_merge("Pod", name, ns, tmutate)

    def quota(self, ns, min_chips, max_chips, used_chips=0):
        self.jstore.create(jeq.ElasticQuota(
            metadata=jobj.ObjectMeta(name="q", namespace=ns),
            spec=jeq.ElasticQuotaSpec(min={jconstants.RESOURCE_TPU_CHIPS: min_chips},
                                      max={jconstants.RESOURCE_TPU_CHIPS: max_chips}),
            status=jeq.ElasticQuotaStatus(used={jconstants.RESOURCE_TPU_CHIPS: used_chips})))
        self.tstore.create(ElasticQuota("q", ns, min={RESOURCE_GPU_MEMORY: 10 * min_chips},
                                        max={RESOURCE_GPU_MEMORY: 10 * max_chips},
                                        used={RESOURCE_GPU_MEMORY: 10 * used_chips}))

    def delete(self, kind, name, ns=""):
        self.jstore.delete(kind, name, ns)
        self.tstore.delete(kind, name, ns)

    def observe(self, t, **kw):
        self.jledger.observe(t, **kw)
        self.tledger.observe(t, **kw)

    def gang(self, method, gang, t):
        getattr(self.jledger, method)(gang, t)
        getattr(self.tledger, method)(gang, t)

    def totals(self):
        """The port's totals, asserted equal to the reference's x 10."""
        want, got = self.jledger.totals(), self.tledger.totals()
        assert got["total"] == 10 * want["total"]
        assert got["busy"] == 10 * want["busy"]
        assert got["idle"] == {k: 10 * v for k, v in want["idle"].items()}
        assert got["reasons"] == {k: 10 * v for k, v in want["reasons"].items()}
        assert got["pools"] == {{"tpu": "mig"}.get(k, k): {s: 10 * x for s, x in v.items()}
                                for k, v in want["pools"].items()}
        assert got["namespaces"] == {k: 10 * v for k, v in want["namespaces"].items()}
        assert self.tledger.gang_clocks() == self.jledger.gang_clocks()
        assert self.tledger.reconfig_stats() == self.jledger.reconfig_stats()
        assert self.tledger.utilization() == self.jledger.utilization()
        assert self.tledger.idle_pending_fraction() == self.jledger.idle_pending_fraction()
        assert self.tledger.self_check() == []
        return got


def case_busy_and_idle(b):
    b.node("n1")
    b.node("n2")
    b.pod("w", "4g.40gb", node="n1")
    b.observe(T0)
    b.observe(T0 + 10)
    t = b.totals()
    assert (t["total"], t["busy"], t["idle"][BUCKET_NO_DEMAND]) == (1600.0, 400.0, 1200.0)


def case_interval_integrates_the_state_before_the_writes(b):
    b.node("n1")
    b.observe(T0)
    b.pod("w", "7g.80gb", node="n1")
    b.observe(T0 + 5)
    assert b.totals()["busy"] == 0.0
    b.observe(T0 + 15)
    assert b.totals()["busy"] == 800.0


def case_pending_coverage_rule(b):
    b.node("n1")
    b.pod("pend", "4g.40gb")
    b.observe(T0, unserved={"default/pend": "insufficient capacity: 4"})
    b.observe(T0 + 10)
    t = b.totals()
    assert t["idle"][BUCKET_PENDING] == 400.0 and t["reasons"] == {"insufficient capacity": 400.0}


def case_frozen_node_idles_into_reconfig(b):
    b.node("n1", annotations={SPEC_PLAN: "plan-2", STATUS_PLAN: "plan-1"})
    b.pod("pend", "4g.40gb")
    b.observe(T0)
    b.observe(T0 + 10)
    t = b.totals()
    assert t["idle"][BUCKET_RECONFIG] == 800.0 and t["idle"][BUCKET_PENDING] == 0.0


def case_reserved_node_idles_into_its_bucket(b):
    b.node("n1", annotations={RESERVED_FOR: "ml/gang-leader"})
    b.observe(T0)
    b.observe(T0 + 10)
    assert b.totals()["idle"][BUCKET_RESERVED] == 800.0


def case_autoscaler_grace_idles_into_its_bucket_then_back(b):
    b.node("n1", annotations={GRACE[0]: "default.svc", GRACE[1]: str(T0 + 60)})
    b.observe(T0)
    b.observe(T0 + 10)
    assert b.totals()["idle"][BUCKET_AUTOSCALER] == 800.0
    b.annotate("n1", {GRACE[0]: None, GRACE[1]: None})
    b.observe(T0 + 20)
    b.observe(T0 + 30)
    t = b.totals()
    assert t["idle"][BUCKET_AUTOSCALER] == 1600.0 and t["idle"][BUCKET_NO_DEMAND] == 800.0


def case_namespace_and_pool_rollups(b):
    b.node("n1")
    b.pod("a", "2g.20gb", ns="ml", node="n1")
    b.pod("b", "4g.40gb", ns="batch", node="n1")
    b.observe(T0)
    b.observe(T0 + 10)
    t = b.totals()
    assert t["namespaces"] == {"ml": 200.0, "batch": 400.0}
    assert t["pools"]["mig"] == {"total": 800.0, "busy": 600.0}


def case_finished_pod_stops_accruing(b):
    b.node("n1")
    b.pod("w", "7g.80gb", node="n1")
    b.observe(T0)
    b.observe(T0 + 10)
    b.set_pod("w", phase="Succeeded")
    b.observe(T0 + 11)
    b.observe(T0 + 21)
    assert b.totals()["busy"] == 880.0


def case_node_delete_drops_from_accounting(b):
    b.node("n1")
    b.observe(T0)
    b.delete("Node", "n1")
    b.observe(T0 + 10)
    b.observe(T0 + 20)
    assert b.totals()["total"] == 800.0


def case_busy_capped_at_capacity(b):
    b.node("n1")
    b.pod("a", "7g.80gb", node="n1")
    b.pod("b", "7g.80gb", node="n1")
    b.observe(T0)
    b.observe(T0 + 10)
    assert b.totals()["busy"] == 800.0


def case_gang_clocks_flow(b):
    b.gang("note_gang_arrival", "ml/g1", T0)
    b.gang("note_gang_arrival", "ml/g1", T0 + 1)
    b.gang("note_gang_feasible", "ml/g1", T0 + 2)
    b.gang("note_gang_feasible", "ml/g1", T0 + 3)
    b.gang("note_gang_bound", "ml/g1", T0 + 4)
    assert list(b.tledger.recent_gangs) == [
        {"gang": "ml/g1", "wait_seconds": 4.0, "feasible_after": 2.0}]
    b.gang("note_gang_bound", "ml/g1", T0 + 9)
    b.gang("note_gang_arrival", "ml/g2", T0)
    b.jledger.drop_gang("ml/g2")
    b.tledger.drop_gang("ml/g2")
    assert len(b.tledger.recent_gangs) == 1
    b.totals()


def case_gang_deleted_before_bound_drops_its_clock(b):
    b.node("n1")
    b.pod("g0", gang=("big", 2))
    b.pod("g1", gang=("big", 2))
    b.observe(T0)
    b.gang("note_gang_arrival", "default/big", T0)
    b.gang("note_gang_feasible", "default/big", T0 + 2)
    b.delete("Pod", "g0", "default")
    b.observe(T0 + 3)
    b.totals()
    assert "default/big" in b.tledger.gang_clocks()
    b.delete("Pod", "g1", "default")
    b.observe(T0 + 4)
    b.totals()
    assert b.tledger.gang_clocks() == {}


def case_gang_rearrival_gets_a_fresh_clock(b):
    b.pod("g0", gang=("big", 2))
    b.observe(T0)
    b.gang("note_gang_arrival", "default/big", T0)
    b.delete("Pod", "g0", "default")
    b.observe(T0 + 5)
    b.pod("g0", gang=("big", 2))
    b.pod("g1", gang=("big", 2))
    b.observe(T0 + 10)
    b.gang("note_gang_arrival", "default/big", T0 + 10)
    assert b.tledger.gang_clocks()["default/big"]["arrival"] == T0 + 10
    b.gang("note_gang_bound", "default/big", T0 + 12)
    b.totals()


def case_preempt_then_resubmit(b):
    b.node("n1")
    b.pod("g0", node="n1", gang=("big", 2))
    b.pod("g1", node="n1", gang=("big", 2))
    b.observe(T0)
    b.gang("note_gang_arrival", "default/big", T0)
    b.gang("note_gang_bound", "default/big", T0 + 2)
    b.delete("Pod", "g0", "default")
    b.delete("Pod", "g1", "default")
    b.observe(T0 + 20)
    b.pod("g0", gang=("big", 2))
    b.pod("g1", gang=("big", 2))
    b.observe(T0 + 21)
    b.gang("note_gang_arrival", "default/big", T0 + 21)
    b.gang("note_gang_bound", "default/big", T0 + 26)
    b.totals()
    assert [r["wait_seconds"] for r in b.tledger.recent_gangs] == [2.0, 5.0]


def case_frozen_edges_measure_reconfig_seconds(b):
    b.node("n1")
    b.observe(T0)
    b.annotate("n1", {SPEC_PLAN: "p1"})
    b.observe(T0 + 1)
    assert b.tledger.reconfig_stats()["in_flight"] == ["n1"]
    b.annotate("n1", {STATUS_PLAN: "p1"})
    b.observe(T0 + 4)
    b.totals()
    assert b.tledger.mean_reconfig_seconds() == 3.0


def case_node_deleted_mid_reconfig_drops_the_edge(b):
    b.node("n1")
    b.observe(T0)
    b.annotate("n1", {SPEC_PLAN: "p1"})
    b.observe(T0 + 1)
    b.delete("Node", "n1")
    b.observe(T0 + 2)
    b.totals()
    assert b.tledger.mean_reconfig_seconds(default=0.5) == 0.5


def case_quotas_and_lifecycle_state(b):
    b.node("n1")
    b.node("n2", gpus=2)
    b.quota("ml", 8, 16, 4)
    b.pod("a", "4g.40gb", node="n1")
    b.pod("b", "7g.80gb", ns="ml")
    b.delete("Node", "n2")
    b.observe(T0)
    b.totals()
    assert b.tledger._canonical_state() == state_from_store(b.tstore)
    assert b.tledger._quotas == {"ml/q": ("ml", 80, 160, 40)}


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_matches_the_reference_cases(case):
    CASES[case](Both())


def _random_ops(b, rng, steps):
    nodes, pods = [], []
    t = T0
    b.observe(t)
    for step in range(steps):
        op = rng.random()
        if op < 0.15 or not nodes:
            name = f"n{step}"
            ann = rng.choice([{}, {}, {SPEC_PLAN: "p2", STATUS_PLAN: "p1"},
                              {RESERVED_FOR: "ml/x"}, {GRACE[0]: "default.s", GRACE[1]: "1"}])
            b.node(name, gpus=rng.choice([1, 1, 2]), annotations=ann)
            nodes.append(name)
        elif op < 0.45:
            pod = (f"p{step}", rng.choice(["default", "ml"]))
            gang = rng.choice([None, None, ("g", 2), ("h", 1)])
            b.pod(pod[0], rng.choice(sorted(CHIPS)), ns=pod[1],
                  node=rng.choice(["", rng.choice(nodes)]), gang=gang,
                  phase=rng.choice(["Pending", "Running"]))
            pods.append(pod)
        elif op < 0.6 and pods:
            name, ns = rng.choice(pods)
            b.set_pod(name, ns, node=rng.choice(nodes),
                      phase=rng.choice([None, "Running", "Succeeded"]))
        elif op < 0.7 and pods:
            name, ns = pods.pop(rng.randrange(len(pods)))
            b.delete("Pod", name, ns)
        elif op < 0.8:
            b.annotate(rng.choice(nodes), rng.choice([
                {SPEC_PLAN: f"p{step}"}, {STATUS_PLAN: f"p{step}"}, {RESERVED_FOR: None},
                {RESERVED_FOR: "ml/y"}, {GRACE[0]: None, GRACE[1]: None}]))
        elif op < 0.85 and len(nodes) > 1:
            b.delete("Node", nodes.pop(rng.randrange(len(nodes))))
        else:
            t += rng.choice([1, 2, 5])
            unserved = rng.choice([None, {}, {f"default/p{step}": rng.choice(
                ["insufficient capacity: x", "gang excluded: g", "no node fits"])}])
            b.observe(t, unserved=unserved)
            b.totals()
    b.observe(t + 3)
    return b.totals()


@pytest.mark.parametrize("seed", range(6))
def test_ledger_matches_the_reference_on_random_write_sequences(seed):
    totals = _random_ops(Both(), random.Random(4000 + seed), 150)
    assert totals["total"] > 0


def test_dominant_reason_is_the_count_then_the_name():
    pods = [("p1", "beta"), ("p2", "alpha"), ("p3", "beta"), ("p4", "alpha"), ("p5", "gamma")]
    for perm in itertools.permutations(pods):
        assert dominant_unserved_reason(dict(perm)) == "alpha"
    assert dominant_unserved_reason({"a": "zzz", "b": "zzz", "c": "aaa"}) == "zzz"
    assert dominant_unserved_reason({}) is None


def test_self_check_detects_a_corrupted_state_and_skips_a_moving_store():
    store = NodeStore()
    ledger = CapacityLedger(store, metrics=False)
    store.create(port_node(NodeDesc("n1")))
    ledger.observe(T0)
    store.create(Pod("racer", request={"nvidia.com/mig-1g.10gb": 1}))
    assert ledger.self_check() == []  # the store moved past the watermark
    ledger.observe(T0 + 1)
    assert ledger.self_check() == []
    ledger._bound["default/ghost"] = ("n1", 40, "default")
    assert "bound[default/ghost]" in ledger.self_check()[0]


def test_mps_slices_and_plain_gpus_count_their_gb():
    """Port only: an MPS slice holds its GB, a plain GPU 80."""
    store = NodeStore()
    ledger = CapacityLedger(store, metrics=False)
    store.create(port_node(NodeDesc("m1", gpus=2, mode="mps")))
    store.create(Pod("s", node="m1", phase=PodPhase.RUNNING, request={"nvidia.com/gpu-20gb": 2}))
    store.create(Pod("g", node="m1", phase=PodPhase.RUNNING, request={"nvidia.com/gpu": 1}))
    ledger.observe(0.0)
    ledger.observe(2.0)
    totals = ledger.totals()
    assert totals["total"] == 320.0 and totals["busy"] == 240.0
    assert totals["pools"] == {"mps": {"total": 320.0, "busy": 240.0}}


def test_a_reader_behind_the_journal_rebuilds(monkeypatch):
    from nos_tpu_torch.kube import store as store_mod

    monkeypatch.setattr(store_mod, "JOURNAL_LENGTH", 5)
    store = NodeStore()
    ledger = CapacityLedger(store, metrics=False)
    store.create(port_node(NodeDesc("n1")))
    ledger.observe(0.0)
    for i in range(8):
        store.create(Pod(f"p{i}", node="n1", phase=PodPhase.RUNNING,
                         request={"nvidia.com/mig-1g.10gb": 1}))
    store.delete("Pod", "p0", "default")
    ledger.observe(1.0)
    assert ledger.self_check() == []
    ledger.observe(2.0)
    assert ledger.totals()["busy"] == 70.0
