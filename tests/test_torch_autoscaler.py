"""The model autoscaler (nos_tpu_torch.controllers.autoscaler,
nos_tpu_torch.api.v1alpha1.modelserving) against
nos_tpu.controllers.autoscaler.

``decide`` is held to the reference's on its ten cases
(tests/controllers/test_autoscaler.py:41-102) and on 500 random
(spec, current, signals, now, last transition) tuples: the same
Decision, reason text included. The reconciler's cases (:151-295) run
on both stores, translated: a v5e node of one 2x4 board is a MIG node of
one H100, a replica asking ``google.com/tpu: 8`` one asking
``nvidia.com/mig-7g.80gb: 1``; the pod names, requests, labels, the grace
annotations and the status are compared after every reconcile.
"""
import math
import random

import pytest

from nos_tpu.api.config import AutoscalerConfig as JConfig
from nos_tpu.api.v1alpha1 import annotations as jannot
from nos_tpu.api.v1alpha1 import constants as jconstants
from nos_tpu.api.v1alpha1 import labels as jlabels
from nos_tpu.api.v1alpha1.modelserving import ModelServing as JModelServing
from nos_tpu.api.v1alpha1.modelserving import ModelServingSpec as JSpec
from nos_tpu.controllers.autoscaler import ModelServingReconciler as JReconciler
from nos_tpu.controllers.autoscaler import SignalRegistry as JRegistry
from nos_tpu.controllers.autoscaler import policy as jpolicy
from nos_tpu.controllers.autoscaler.signals import Signals as JSignals
from nos_tpu.kube.controller import Request
from nos_tpu.kube.objects import ObjectMeta
from nos_tpu.kube.store import KubeStore
from nos_tpu.scheduler.plugins.gang import GANG_NAME_LABEL as J_GANG_NAME
from nos_tpu.scheduler.plugins.gang import GANG_SIZE_LABEL as J_GANG_SIZE
from nos_tpu_torch.api.config import AutoscalerConfig, ConfigError
from nos_tpu_torch.api.v1alpha1 import MODEL_SERVING_LABEL, ModelServing, ModelServingSpec
from nos_tpu_torch.cluster import SimCluster
from nos_tpu_torch.controllers.autoscaler import ModelServingReconciler, SignalRegistry, policy
from nos_tpu_torch.controllers.autoscaler.controller import (
    pod_to_serving_requests,
    replica_name,
    serving_key,
)
from nos_tpu_torch.controllers.autoscaler.signals import Signals
from nos_tpu_torch.gpu import annotations as tannot
from nos_tpu_torch.kube.store import NodeStore
from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL, GANG_SIZE_LABEL
from tests.factory import build_tpu_node
from tests.torch_planner_cases import TO_TPU, NodeDesc, port_node

CFG = dict(scale_down_stable_seconds=30.0, recent_activity_seconds=10.0)
SPEC = dict(model="m", min_replicas=0, max_replicas=3, slos=["p95 ttft < 500ms"],
            scale_to_zero_idle_seconds=60.0, cold_start_grace_seconds=30.0,
            target_queue_depth=4)


def specs(**kw):
    """(reference spec on 2x4 boards, port spec on 7g.80gb)."""
    base = dict(SPEC, **kw)
    return JSpec(slice_profile="2x4", **base), ModelServingSpec(slice_profile="7g.80gb", **base)


def decide_both(spec_kw, current, sig_kw, now, last=0.0):
    jspec, tspec = specs(**spec_kw)
    want = jpolicy.decide(jspec, current, JSignals(**sig_kw), JConfig(**CFG), now,
                          last_transition_t=last)
    got = policy.decide(tspec, current, Signals(**sig_kw), AutoscalerConfig(**CFG), now,
                        last_transition_t=last)
    assert (got.desired, got.verdict, got.reason) == (want.desired, want.verdict, want.reason)
    return got


# the reference's TestDecide cases: (spec, current, signals, now, last
# transition, desired, verdict)
DECIDE_CASES = {
    "hold_inside_band": ({}, 1, dict(last_request_t=95.0), 100.0, 0.0, 1, "hold"),
    "scale_up_on_fast_burn": ({}, 1, dict(burn_fast=1.5, last_request_t=99.0), 100.0, 0.0, 2,
                              "scale-up"),
    "scale_up_on_backlog": ({}, 2, dict(queue_depth=9, last_request_t=99.0), 100.0, 0.0, 3,
                            "scale-up"),
    "no_scale_up_past_max": (dict(max_replicas=2), 2, dict(burn_fast=9.0, last_request_t=99.0),
                             100.0, 0.0, 2, "hold"),
    "below_min_heals": (dict(min_replicas=2), 1, {}, 100.0, 0.0, 2, "scale-up"),
    "scale_down_needs_stability": ({}, 2, dict(burn_fast=0.1, burn_slow=0.1,
                                               error_budget_remaining=0.9, last_request_t=99.0),
                                   100.0, 80.0, 2, "hold"),
    "scale_down_on_surplus": ({}, 2, dict(burn_fast=0.1, burn_slow=0.1,
                                          error_budget_remaining=0.9, last_request_t=99.0),
                              120.0, 80.0, 1, "scale-down"),
    "one_transition_per_timestamp": ({}, 2, dict(burn_fast=9.0, last_request_t=99.0), 100.0,
                                     100.0, 2, "hold"),
    "cold_start_jumps_to_min_floor": (dict(min_replicas=2), 0, dict(queue_depth=3), 100.0, 0.0,
                                      2, "cold-start"),
    "standing_slo_scales_to_zero": ({}, 1, dict(queue_depth=0, last_request_t=10.0), 100.0,
                                    20.0, 0, "scale-to-zero"),
    "min_floor_blocks_scale_to_zero": (dict(min_replicas=1), 1, dict(last_request_t=10.0),
                                       500.0, 20.0, 1, "hold"),
    "budget_below_surplus_holds": ({}, 2, dict(burn_fast=0.1, burn_slow=0.1,
                                               error_budget_remaining=0.2,
                                               last_request_t=119.0), 120.0, 80.0, 2, "hold"),
}


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_matches_the_reference_cases(case):
    spec_kw, current, sig_kw, now, last, desired, verdict = DECIDE_CASES[case]
    got = decide_both(spec_kw, current, sig_kw, now, last)
    assert (got.desired, got.verdict) == (desired, verdict)


def _random_tuple(rng):
    lo = rng.choice([0, 0, 0, 1, 2])
    spec_kw = dict(min_replicas=lo, max_replicas=rng.randint(max(1, lo), 5),
                   scale_to_zero_idle_seconds=rng.choice([0.0, 30.0, 60.0, 300.0]),
                   target_queue_depth=rng.randint(1, 8),
                   scale_down_budget_surplus=rng.choice([0.0, 0.25, 0.5, 1.0]))
    sig_kw = dict(burn_fast=rng.choice([0.0, 0.0, 0.2, 0.5, 0.9, 1.0, 1.5, 4.0]),
                  burn_slow=rng.choice([0.0, 0.0, 0.3, 0.5, 2.0]),
                  error_budget_remaining=rng.choice([0.0, 0.2, 0.5, 0.9, 1.0, 1.0]),
                  queue_depth=rng.choice([0, 0, 0, 1, 3, 9, 30]),
                  last_request_t=rng.choice([-math.inf, 0.0, 10.0, 50.0, 90.0, 99.5]))
    now = rng.choice([60.0, 100.0, 200.0, 400.0])
    last = rng.choice([0.0, 0.0, 10.0, 40.0, 80.0, 99.0, 100.0, 150.0])
    return spec_kw, rng.randint(0, 6), sig_kw, now, last


@pytest.mark.parametrize("chunk", range(5))
def test_decide_matches_the_reference_on_random_tuples(chunk):
    rng = random.Random(2000 + chunk)
    verdicts = set()
    for _ in range(100):
        spec_kw, current, sig_kw, now, last = _random_tuple(rng)
        verdicts.add(decide_both(spec_kw, current, sig_kw, now, last).verdict)
    assert len(verdicts) >= 4, verdicts


# ------------------------------------------------------------ the reconciler

class Rigs:
    """The reference's _Rig and its translation: three nodes, one
    ModelServing ``svc``, a clock both sides read."""

    def __init__(self, **spec_kw):
        self.t = 0.0
        jspec, tspec = specs(**spec_kw)
        self.jstore = KubeStore()
        self.jsignals = JRegistry(now_fn=lambda: self.t)
        self.jrec = JReconciler(self.jstore, JConfig(**CFG), signals=self.jsignals)
        self.jstore.create(JModelServing(metadata=ObjectMeta(name="svc", namespace="default"),
                                         spec=jspec))
        self.tstore = NodeStore(clock=lambda: self.t)
        self.tsignals = SignalRegistry(now_fn=lambda: self.t)
        self.trec = ModelServingReconciler(self.tstore, AutoscalerConfig(**CFG),
                                           signals=self.tsignals)
        self.tstore.create(ModelServing("svc", "default", spec=tspec))
        for i in range(3):
            self.jstore.create(build_tpu_node(name=f"n{i}"))
            self.tstore.create(port_node(NodeDesc(f"n{i}")))

    def signal(self, method, *args, **kw):
        getattr(self.jsignals, method)("m", *args, **kw)
        getattr(self.tsignals, method)("m", *args, **kw)

    def reconcile(self):
        self.jrec.reconcile(Request(name="svc", namespace="default"))
        self.trec.reconcile("svc", "default")
        self.assert_same()

    def bind(self, pod, node):
        def mutate(p):
            p.spec.node_name = node

        self.jstore.patch_merge("Pod", pod, "default", mutate)
        self.tstore.patch_merge("Pod", pod, "default", lambda p: setattr(p, "node", node))

    def delete(self, kind, name, ns=""):
        self.jstore.delete(kind, name, ns)
        self.tstore.delete(kind, name, ns)

    def pods(self):
        return [p.name for p in self.tstore.list("Pod")]

    def status(self):
        return self.tstore.get("ModelServing", "svc", "default").status

    def assert_same(self):
        jpods = {p.metadata.name: p for p in self.jstore.list("Pod")}
        tpods = {p.name: p for p in self.tstore.list("Pod")}
        assert sorted(tpods) == sorted(jpods)
        for name, tpod in tpods.items():
            jpod = jpods[name]
            requests = jpod.spec.containers[0].requests
            assert requests == {jconstants.RESOURCE_TPU: 8}
            assert tpod.request == {"nvidia.com/mig-7g.80gb": 1}
            assert tpod.labels == {MODEL_SERVING_LABEL: jpod.metadata.labels[
                jlabels.MODEL_SERVING_LABEL], GANG_NAME_LABEL: jpod.metadata.labels[J_GANG_NAME],
                GANG_SIZE_LABEL: jpod.metadata.labels[J_GANG_SIZE]}
            assert tpod.node == jpod.spec.node_name
        grace = (jannot.AUTOSCALER_RESERVED, jannot.AUTOSCALER_RESERVED_UNTIL)
        jgrace = {n.metadata.name: {k: n.metadata.annotations.get(k) for k in grace}
                  for n in self.jstore.list("Node")}
        tgrace = {n.name: {k: n.annotations.get(k) for k in
                           (tannot.AUTOSCALER_RESERVED, tannot.AUTOSCALER_RESERVED_UNTIL)}
                  for n in self.tstore.list("Node")}
        assert [list(v.values()) for _, v in sorted(tgrace.items())] == [
            list(v.values()) for _, v in sorted(jgrace.items())]
        jms = self.jstore.try_get("ModelServing", "svc", "default")
        tms = self.tstore.try_get("ModelServing", "svc", "default")
        assert (jms is None) == (tms is None)
        if tms is not None:
            assert vars(tms.status) == vars(jms.status)


def _cold_start(rigs, node="n1"):
    rigs.t = 100.0
    rigs.signal("note_arrival", 99.0, queue_depth=5)
    rigs.reconcile()
    rigs.bind(replica_name("svc", 0), node)


def case_cold_start_creates_dense_replicas(rigs):
    rigs.t = 100.0
    rigs.signal("note_arrival", 99.0, queue_depth=5)
    rigs.reconcile()
    assert rigs.pods() == [replica_name("svc", 0)]
    assert rigs.status().last_verdict == policy.VERDICT_COLD_START
    assert rigs.status().cold_starts == 1


def case_scale_up_is_idempotent_at_one_timestamp(rigs):
    rigs.t = 100.0
    rigs.signal("note_arrival", 99.0, queue_depth=5)
    rigs.reconcile()
    rigs.reconcile()
    assert rigs.pods() == [replica_name("svc", 0)]


def case_scale_down_deletes_top_and_reserves_nodes(rigs):
    _cold_start(rigs)
    rigs.t = 300.0
    rigs.signal("update", queue_depth=0)
    rigs.reconcile()
    assert rigs.pods() == [] and rigs.status().last_verdict == policy.VERDICT_SCALE_TO_ZERO
    node = rigs.tstore.get("Node", "n1")
    assert node.annotations[tannot.AUTOSCALER_RESERVED] == "default.svc"
    assert float(node.annotations[tannot.AUTOSCALER_RESERVED_UNTIL]) == pytest.approx(330.0)


def case_grace_reservation_expires_on_its_clock(rigs):
    _cold_start(rigs)
    rigs.t = 300.0
    rigs.signal("update", queue_depth=0)
    rigs.reconcile()
    rigs.t = 331.0
    rigs.reconcile()
    assert tannot.AUTOSCALER_RESERVED not in rigs.tstore.get("Node", "n1").annotations


def case_arrival_during_teardown_cold_starts_again(rigs):
    _cold_start(rigs)
    rigs.t = 300.0
    rigs.signal("update", queue_depth=0)
    rigs.reconcile()
    rigs.t = 301.0
    rigs.signal("note_arrival", 300.5, queue_depth=2)
    rigs.reconcile()
    assert rigs.pods() == [replica_name("svc", 0)] and rigs.status().cold_starts == 2


def case_cold_start_with_node_mid_recarve(rigs):
    _cold_start(rigs)
    rigs.t = 300.0
    rigs.signal("update", queue_depth=0)
    rigs.reconcile()
    rigs.delete("Node", "n1")
    rigs.t = 302.0
    rigs.signal("note_arrival", 301.0, queue_depth=1)
    rigs.reconcile()
    assert rigs.pods() == [replica_name("svc", 0)]


def case_standing_slo_does_not_hold_replicas(rigs):
    _cold_start(rigs, node="n0")
    rigs.t = 500.0
    rigs.signal("update", queue_depth=0, burn_fast=0.0, burn_slow=0.0,
                error_budget_remaining=1.0)
    rigs.reconcile()
    assert rigs.pods() == [] and rigs.status().last_verdict == policy.VERDICT_SCALE_TO_ZERO


def case_deleted_modelserving_collects_orphans(rigs):
    rigs.t = 100.0
    rigs.signal("note_arrival", 99.0, queue_depth=5)
    rigs.reconcile()
    rigs.delete("ModelServing", "svc", "default")
    rigs.reconcile()
    assert rigs.pods() == []


def case_fleet_up_then_down(rigs):
    """Cold start, two scale-ups on burn, then budget-surplus scale-downs
    from the top and a scale to zero, every replica bound in between."""
    _cold_start(rigs, node="n0")
    for t, burn, node in ((110.0, 2.0, "n1"), (120.0, 2.0, "n2")):
        rigs.t = t
        rigs.signal("update", burn_fast=burn, last_request_t=t - 1)
        rigs.reconcile()
        rigs.bind(rigs.pods()[-1], node)
    for t in (160.0, 200.0, 400.0):
        rigs.t = t
        rigs.signal("update", burn_fast=0.0, burn_slow=0.0, error_budget_remaining=0.9,
                    queue_depth=0)
        rigs.reconcile()
    assert rigs.pods() == [] and rigs.status().last_verdict == policy.VERDICT_SCALE_TO_ZERO


RECONCILER_CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
                    if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(RECONCILER_CASES))
def test_reconciler_writes_match_the_reference(case):
    RECONCILER_CASES[case](Rigs())


def test_replica_pods_are_gangs_of_one_asking_a_mig_instance():
    rigs = Rigs()
    _cold_start(rigs)
    pod = rigs.tstore.get("Pod", replica_name("svc", 0), "default")
    assert pod.labels[GANG_SIZE_LABEL] == "1"
    assert pod.labels[GANG_NAME_LABEL] == replica_name("svc", 0)
    assert pod.request == {"nvidia.com/mig-7g.80gb": 1}
    assert pod_to_serving_requests(pod) == [("svc", "default")]
    assert TO_TPU["7g.80gb"] == "2x4"


# ------------------------------------------------------------ port only

def test_spec_validation_and_chips_per_replica():
    spec = ModelServingSpec(model="m", slice_profile="3g.40gb", slos=["p95 ttft < 1s"])
    spec.validate()
    assert spec.chips_per_replica == 4
    assert ModelServingSpec(model="m").chips_per_replica == 8  # 7g.80gb
    for bad in (dict(model=""), dict(slice_profile="2x4"), dict(min_replicas=-1),
                dict(min_replicas=3, max_replicas=2), dict(slos=["p95 nonsense"]),
                dict(target_queue_depth=0), dict(scale_down_budget_surplus=1.5)):
        with pytest.raises(ValueError):
            ModelServingSpec(**dict(dict(model="m"), **bad)).validate()
    with pytest.raises(ConfigError):
        AutoscalerConfig(scale_down_burn_threshold=2.0).validate()


def test_step_reconciles_every_serving_and_keeps_its_decisions():
    store = NodeStore(clock=lambda: 50.0)
    store.create(port_node(NodeDesc("n0")))
    rec = ModelServingReconciler(store, AutoscalerConfig(**CFG))
    store.create(ModelServing("a", spec=ModelServingSpec(model="a", min_replicas=1)))
    store.create(ModelServing("b", spec=ModelServingSpec(model="b", min_replicas=2,
                                                         max_replicas=2)))
    assert rec.signals.now() == 50.0  # the store's clock by default
    rec.step()
    assert [p.name for p in store.list("Pod")] == ["a-replica-0", "b-replica-0", "b-replica-1"]
    assert [d["verdict"] for d in rec.decisions] == ["scale-up", "scale-up"]
    store.delete("ModelServing", "b", "default")
    rec.step()  # the orphans of b go
    assert [p.name for p in store.list("Pod")] == ["a-replica-0"]


def test_sim_cluster_places_min_replicas_and_scales_to_zero():
    """The wired component (the reference's build_cluster test): a
    ModelServing's replica is carved for and bound, and an idle cold
    model scales to zero with its node held in grace, then released."""
    cluster = SimCluster(autoscaler=AutoscalerConfig(recent_activity_seconds=1.0),
                         capacity_ledger=True)
    cluster.add_mig_node("gpu-0", gpus=1)
    cluster.add_mig_node("gpu-1", gpus=1)
    cluster.store.create(ModelServing("svc", spec=ModelServingSpec(
        model="svc", slice_profile="3g.40gb", min_replicas=1, max_replicas=1)))
    cluster.store.create(ModelServing("cold", spec=ModelServingSpec(
        model="cold", min_replicas=0, max_replicas=1, scale_to_zero_idle_seconds=2.0,
        cold_start_grace_seconds=3.0)))
    cluster.autoscaler.signals.note_arrival("cold", 0.0, queue_depth=1)
    for _ in range(20):
        cluster.step()
    pods = {p.name: p for p in cluster.store.list("Pod")}
    assert pods["svc-replica-0"].node and pods["cold-replica-0"].node
    held = pods["cold-replica-0"].node
    cluster.autoscaler.signals.update("cold", queue_depth=0)
    for _ in range(60):
        cluster.step()
    assert "cold-replica-0" not in [p.name for p in cluster.store.list("Pod")]
    assert tannot.AUTOSCALER_RESERVED in cluster.store.get("Node", held).annotations
    for _ in range(80):
        cluster.step()
    assert tannot.AUTOSCALER_RESERVED not in cluster.store.get("Node", held).annotations
    assert all(cluster.check().values()), cluster.check()
    idle = cluster.ledger.totals()["idle"]
    assert idle["autoscaler-grace"] > 0 and idle["no-demand"] > 0
    payload = cluster.autoscaler.debug_payload()
    assert payload["servings"]["default/svc"]["ready_replicas"] == 1
    assert serving_key(cluster.store.get("ModelServing", "svc", "default")) == "default.svc"
