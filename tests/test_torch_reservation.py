"""The drain reservation and the autoscaler's grace score
(nos_tpu_torch.scheduler.plugins.reservation) against nos_tpu's.

Exact, on translated cases (tests/torch_quota_cases.py; a v5e node of
one 2x4 board per GPU ↔ an H100 MIG node, a board's 8 chips ↔ a GPU's 8
memory slices): the filter's verdict and message for valid, stale,
expired and own reservations; ``try_reserve``'s answer and the node it
annotates on random MIG clusters (running pods, in-flight claims, other
holders, young and old pods, requests below and above a whole GPU), with
the reference's ``time`` driven by the test's clock; the TTL refresh;
``release_invalid``, ``release_for`` and ``any_reserved``; and the
scheduler's flow, a blocked whole-GPU pod reserving a node whose bind
releases it. On the port alone: MPS nodes are never reserved.
"""
import random

import pytest

from nos_tpu.scheduler import framework as jfw
from nos_tpu.scheduler.plugins import reservation as jres
from nos_tpu_torch.scheduler import framework as tfw
from nos_tpu_torch.scheduler.plugins import reservation as tres
from tests.torch_planner_cases import MIG_PROFILES, NodeDesc, same_tables
from tests.torch_quota_cases import (
    Both,
    Clock,
    RefReservation,
    PodDesc,
    drive_ref_time,
    mig,
    mps,
    reservations,
    stores,
)

WHOLE = mig("7g.80gb")


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


def test_annotation_keys_match_the_reference():
    assert (tres.RESERVED_FOR, tres.RESERVED_AT) == (jres.RESERVED_FOR, jres.RESERVED_AT)


class Sides:
    """Both stores, both plugins, one clock."""

    def __init__(self, monkeypatch, nodes, pods):
        self.clock = Clock()
        drive_ref_time(monkeypatch, self.clock)
        self.jstore, self.tstore = stores(nodes=nodes, pods=pods, clock=self.clock)
        self.jres, self.tres = RefReservation(self.jstore), tres.BoardReservation(self.tstore)

    def reserve(self, node, holder, at=None):
        at = self.clock.t if at is None else at
        for store in (self.jstore, self.tstore):
            store.patch_annotations("Node", node, "", {tres.RESERVED_FOR: holder,
                                                       tres.RESERVED_AT: str(at)})

    def infos(self):
        jinfos = {n.metadata.name: jfw.NodeInfo(node=n) for n in self.jstore.list("Node")}
        for p in self.jstore.list("Pod"):
            if p.spec.node_name in jinfos and p.status.phase in ("Pending", "Running"):
                jinfos[p.spec.node_name].add_pod(p)
        tinfos = {n.name: tfw.NodeInfo(node=n) for n in self.tstore.list("Node")}
        for p in self.tstore.list("Pod"):
            if p.node in tinfos and p.phase in ("Pending", "Running"):
                tinfos[p.node].add_pod(p)
        return jinfos, tinfos

    def held(self):
        want, got = reservations(self.jstore, self.tstore)
        assert got == want
        return got


def test_filter_verdicts_match_the_reference(monkeypatch):
    nodes = [(NodeDesc(f"n{i}"), {WHOLE: 1}) for i in range(5)]
    pods = [PodDesc("holder", {WHOLE: 1}), PodDesc("bound", {WHOLE: 1}, node="n4",
                                                   phase="Running"),
            PodDesc("other", {WHOLE: 1})]
    sides = Sides(monkeypatch, nodes, pods)
    sides.reserve("n0", "default/holder")                       # valid
    sides.reserve("n1", "default/gone")                         # no such pod
    sides.reserve("n2", "default/bound")                        # holder bound
    sides.reserve("n3", "default/holder", at=sides.clock.t - 31)  # expired
    jinfos, tinfos = sides.infos()
    for name in ("holder", "other"):
        jpod, tpod = sides.jstore.get("Pod", name, "default"), sides.tstore.get(
            "Pod", name, "default")
        jstate, tstate = jfw.CycleState(), tfw.CycleState()
        for node in sorted(jinfos):
            want = sides.jres.filter(jstate, jpod, jinfos[node])
            got = sides.tres.filter(tstate, tpod, tinfos[node])
            assert (got.code, got.message, got.plugin) == (want.code, want.message,
                                                           want.plugin)
    assert not sides.tres.filter(tfw.CycleState(), sides.tstore.get("Pod", "other", "default"),
                                 tinfos["n0"]).success


def random_reservation_case(rng):
    nodes, pods = [], []
    for i in range(rng.randint(1, 6)):
        desc = NodeDesc(f"n{i}", gpus=rng.randint(1, 2))
        nodes.append((desc, {}))
        for gpu in range(desc.gpus):
            for k in range(rng.choice([0, 1, 1, 2])):
                profile = rng.choice(MIG_PROFILES[1:])
                pods.append(PodDesc(f"r-{i}-{gpu}-{k}", {mig(profile): 1},
                                    node=desc.name, phase="Running", created=0.0))
        if rng.random() < 0.15:
            # an in-flight claim: the node is contested
            pods.append(PodDesc(f"claim-{i}", {mig("1g.10gb"): 1}, node=desc.name,
                                created=0.0))
    request = {rng.choice([WHOLE, WHOLE, mig("4g.40gb")]): rng.choice([1, 1, 2])}
    if rng.random() < 0.15:
        request = {mps("20gb"): 1}
    pods.append(PodDesc("p", request, created=rng.choice([995.0, 0.0, 0.0])))
    pods.append(PodDesc("q", {WHOLE: 1}, created=0.0))
    return nodes, pods


@pytest.mark.parametrize("seed", range(30))
def test_try_reserve_matches_the_reference(monkeypatch, seed):
    rng = random.Random(9900 + seed)
    nodes, pods = random_reservation_case(rng)
    sides = Sides(monkeypatch, nodes, pods)
    names = [d.name for d, _ in nodes]
    if rng.random() < 0.3:
        sides.reserve(rng.choice(names), rng.choice(["default/q", "default/p", "default/x"]),
                      at=sides.clock.t - rng.choice([0.0, 20.0, 40.0]))
    for _ in range(2):
        jinfos, tinfos = sides.infos()
        jpod, tpod = sides.jstore.get("Pod", "p", "default"), sides.tstore.get(
            "Pod", "p", "default")
        assert sides.tres.try_reserve(tpod, tinfos) == sides.jres.try_reserve(jpod, jinfos)
        sides.held()
        sides.clock.t += 16.0
    assert sides.tres.release_invalid() == sides.jres.release_invalid()
    sides.held()
    assert sides.tres.any_reserved() == sides.jres.any_reserved()


def test_ttl_is_refreshed_past_half(monkeypatch):
    nodes = [(NodeDesc("n0"), {})]
    pods = [PodDesc("blocker", {mig("4g.40gb"): 1}, node="n0", phase="Running", created=0.0),
            PodDesc("p", {WHOLE: 1}, created=0.0)]
    sides = Sides(monkeypatch, nodes, pods)
    sides.reserve("n0", "default/p", at=sides.clock.t - 16.0)
    jinfos, tinfos = sides.infos()
    assert sides.tres.try_reserve(sides.tstore.get("Pod", "p", "default"), tinfos)
    assert sides.jres.try_reserve(sides.jstore.get("Pod", "p", "default"), jinfos)
    assert float(sides.tstore.get("Node", "n0").annotations[tres.RESERVED_AT]) == sides.clock.t


def test_release_for_clears_only_the_pods_reservation(monkeypatch):
    nodes = [(NodeDesc(f"n{i}"), {}) for i in range(2)]
    sides = Sides(monkeypatch, nodes, [PodDesc("p", {WHOLE: 1}), PodDesc("q", {WHOLE: 1})])
    sides.reserve("n0", "default/p")
    sides.reserve("n1", "default/q")
    sides.tres.release_for(sides.tstore.get("Pod", "p", "default"))
    sides.jres.release_for(sides.jstore.get("Pod", "p", "default"))
    assert sides.held() == {"n1": "default/q"}


def test_mps_nodes_are_never_reserved():
    """The port alone: a whole-GPU MPS request asks no MIG instance, and an
    MPS node is never a drain candidate."""
    clock = Clock()
    _, tstore = stores(nodes=[(NodeDesc("s0", mode="mps"), {}), (NodeDesc("m0"), {})],
                       pods=[PodDesc("mps-pod", {mps("80gb"): 1}, created=0.0),
                             PodDesc("big", {WHOLE: 1}, created=0.0),
                             PodDesc("held", {mig("4g.40gb"): 1}, node="m0", phase="Running",
                                     created=0.0)], clock=clock)
    plugin = tres.BoardReservation(tstore)
    infos = {n.name: tfw.NodeInfo(node=n) for n in tstore.list("Node")}
    infos["m0"].add_pod(tstore.get("Pod", "held", "default"))
    assert not plugin.try_reserve(tstore.get("Pod", "mps-pod", "default"), infos)
    assert plugin.try_reserve(tstore.get("Pod", "big", "default"), infos)
    reserved = {n.name for n in tstore.list("Node") if tres.RESERVED_FOR in n.annotations}
    assert reserved == {"m0"}


def test_autoscaler_grace_score_matches_the_reference():
    holder = "llama"
    for annotations in ({}, {tres.AUTOSCALER_RESERVED: holder}):
        desc = NodeDesc("n0")
        for labels in ({}, {tres.MODEL_SERVING_LABEL: holder},
                       {tres.MODEL_SERVING_LABEL: "other"}):
            jstore, tstore = stores(nodes=[(desc, {})], pods=[PodDesc("p", labels=labels)])
            jnode, tnode = jstore.get("Node", "n0"), tstore.get("Node", "n0")
            jnode.metadata.annotations.update(annotations)
            tnode.annotations.update(annotations)
            want = jres.AutoscalerGraceScoring().score(
                jfw.CycleState(), jstore.get("Pod", "p", "default"), jfw.NodeInfo(node=jnode))
            got = tres.AutoscalerGraceScoring().score(
                tfw.CycleState(), tstore.get("Pod", "p", "default"), tfw.NodeInfo(node=tnode))
            assert got == want


def test_blocked_whole_gpu_pod_reserves_a_node_and_its_bind_releases_it(monkeypatch):
    """Two MIG nodes, each GPU holding a 4g.40gb and advertising a free
    4g.40gb: a 7g.80gb pod that has waited past ``min_wait`` fails, and the
    node closest to draining is reserved for it; other pods are kept off
    it; once its blocker finishes and the node advertises a 7g.80gb, the
    pod binds there and the reservation goes."""
    nodes = [(NodeDesc("n0"), {mig("4g.40gb"): 2}), (NodeDesc("n1"), {mig("4g.40gb"): 2})]
    pods = [PodDesc("b0", {mig("4g.40gb"): 1}, node="n0", phase="Running", created=0.0),
            PodDesc("b1", {mig("4g.40gb"): 1}, node="n1", phase="Running", created=0.0)]
    both = Both(monkeypatch, nodes, pods=pods)
    both.clock.t += 20.0
    got = both.sched(PodDesc("big", {WHOLE: 1}, created=0.0))
    assert got.decision == "fail"
    held = reservations(both.jstore, both.tstore)
    assert held[1] == held[0] == {"n0": "default/big"}
    got = both.sched(PodDesc("small", {mig("4g.40gb"): 1}))
    assert got.node == "n1"
    for store in (both.jstore, both.tstore):
        store.delete("Pod", "b0", "default")
    both.jstore.patch_merge("Node", "n0", "", lambda n: n.status.allocatable.update(
        {"google.com/tpu-slice-2x4": 1, "google.com/tpu-slice-2x2": 0}))
    both.tstore.patch_merge("Node", "n0", "", lambda n: n.allocatable.update(
        {WHOLE: 1, mig("4g.40gb"): 0}))
    got = both.reconcile("big")
    assert (got.decision, got.node) == ("bind", "n0")
    assert reservations(both.jstore, both.tstore) == ({}, {})


def test_f5_one_drain_across_pod_sizes(monkeypatch):
    """Fault F5: the card-sized node (one GPU) is validly reserved for a
    whole-GPU pod; a pod asking for two whole GPUs skips that node (too
    small) in the reference's loop and reserves a second one there. The
    port, and the reference with the repair, make no second drain."""
    nodes = [(NodeDesc("a-card"), {}), (NodeDesc("n1", gpus=2), {})]
    pods = [PodDesc("held-card", {mig("1g.10gb"): 1}, node="a-card", phase="Running",
                    created=0.0),
            PodDesc("held-n1", {mig("1g.10gb"): 1}, node="n1", phase="Running", created=0.0),
            PodDesc("small", {WHOLE: 1}, created=0.0),
            PodDesc("big", {WHOLE: 2}, created=0.0)]
    sides = Sides(monkeypatch, nodes, pods)
    sides.reserve("a-card", "default/small")
    jinfos, tinfos = sides.infos()
    plain = jres.BoardReservation(sides.jstore)
    assert plain.try_reserve(sides.jstore.get("Pod", "big", "default"), jinfos)
    assert {n.metadata.name for n in sides.jstore.list("Node")
            if jres.RESERVED_FOR in n.metadata.annotations} == {"a-card", "n1"}
    sides.jstore.patch_annotations("Node", "n1", "", {jres.RESERVED_FOR: None,
                                                      jres.RESERVED_AT: None})
    jinfos, tinfos = sides.infos()
    assert not sides.tres.try_reserve(sides.tstore.get("Pod", "big", "default"), tinfos)
    assert not sides.jres.try_reserve(sides.jstore.get("Pod", "big", "default"), jinfos)
    assert sides.held() == {"a-card": "default/small"}
