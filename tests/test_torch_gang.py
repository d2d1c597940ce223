"""Gangs (nos_tpu_torch.scheduler.plugins.gang and the scheduler's Permit,
assume cache, gang release and timeouts) against nos_tpu's.

Exact, on translated cases (tests/torch_quota_cases.py): the reference's
scheduler wired as its ``new_framework`` wires it, driven through its
reconcile without the process-wide unschedulable metric
(``ref_reconcile``), beside the port's ``Scheduler.reconcile``. Time is
one settable instant: the port's store clock, and, patched over the
reference's gang and reservation modules' ``time``, their monotonic and
wall clocks. Each cycle's decision, node, the pods a bind releases,
diagnosis and message, every pod's node and Unschedulable flag, and the
waiting members are held equal.

The cases: tests/scheduler/test_scheduler.py's gang tests (binding
together, the timeout releasing the reservations, bound members
counting, a waiting member not marked unschedulable) on cpu nodes, and
tests/scheduler/test_gang_scale.py's four on one-GPU MIG nodes
advertising a 7g.80gb (one v5e board under the translation), then random
gang arrivals with timeouts.
"""
import random

import pytest

from nos_tpu.scheduler.plugins import gang as jgang
from nos_tpu_torch.api.v1alpha1 import CAPACITY_LABEL, CAPACITY_OVER_QUOTA
from nos_tpu_torch.kube.store import PodPhase
from nos_tpu_torch.scheduler.plugins import gang as tgang
from tests.torch_planner_cases import NodeDesc, same_tables
from tests.torch_quota_cases import (
    GB,
    Both,
    PlainNode,
    PodDesc,
    QuotaDesc,
    gang_pod,
    mig,
    port_pod,
    ref_pod,
)


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


def cpu_node(name, cpu):
    return PlainNode(name, {"cpu": cpu})


def board(name):
    """A one-GPU MIG node advertising one free 7g.80gb."""
    return (NodeDesc(name), {mig("7g.80gb"): 1})


# ------------------------------------------------------------ the plugin

def test_gang_of_matches_the_reference():
    cases = [{}, {tgang.GANG_NAME_LABEL: "job"},
             {tgang.GANG_NAME_LABEL: "job", tgang.GANG_SIZE_LABEL: "x"},
             {tgang.GANG_NAME_LABEL: "job", tgang.GANG_SIZE_LABEL: "0"},
             {tgang.GANG_NAME_LABEL: "job", tgang.GANG_SIZE_LABEL: "3"},
             {tgang.GANG_SIZE_LABEL: "3"}]
    assert tgang.GANG_NAME_LABEL == jgang.GANG_NAME_LABEL
    assert tgang.GANG_SIZE_LABEL == jgang.GANG_SIZE_LABEL
    for labels in cases:
        desc = PodDesc("p", ns="ml", labels=labels)
        assert tgang.gang_of(port_pod(desc)) == jgang.gang_of(ref_pod(desc))


def test_permit_release_and_expiry_match_the_reference(monkeypatch):
    both = Both(monkeypatch, [cpu_node("n1", 8)])
    jg, tg = both.jsched.gang, both.tsched.gang
    members = [gang_pod(f"w{i}", "job", 3) for i in range(3)]
    for desc in members[:2]:
        want = jg.permit(None, ref_pod(desc), "n1")
        got = tg.permit(None, port_pod(desc), "n1")
        assert (got.code, got.message, got.plugin) == (want.code, want.message, want.plugin)
    assert [n for _, n in tg.waiting_members("default/job")] == ["n1", "n1"]
    both.clock.t += 29.0
    assert tg.expired_gangs() == jg.expired_gangs() == []
    both.clock.t += 1.0
    got, want = tg.expired_gangs(), jg.expired_gangs()
    assert [[(p.name, n) for p, n in g] for g in got] == [
        [(p.metadata.name, n) for p, n in g] for g in want] == [[("w0", "n1"), ("w1", "n1")]]
    assert tg.release(port_pod(members[2])) == jg.release(ref_pod(members[2])) == []


# ------------------------------------------------------------ test_scheduler.py

class TestGangScheduling:
    def test_gang_binds_together(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 4), cpu_node("n2", 4)])
        got = both.sched(gang_pod("w0", "job", 2, ns="ml"))
        assert got.decision == "wait" and both.node_of("w0", "ml") == ""
        got = both.sched(gang_pod("w1", "job", 2, ns="ml"))
        assert got.decision == "bind" and len(got.to_bind) == 2
        assert both.node_of("w0", "ml") and both.node_of("w1", "ml")

    def test_gang_timeout_releases_reservations(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 2)], gang_timeout=0.05)
        both.sched(gang_pod("w0", "job", 2, {"cpu": 2}, ns="ml"))
        assert both.node_of("w0", "ml") == ""
        both.clock.t += 0.1
        assert both.tsched.handle_gang_timeouts() == 1
        both.jsched._handle_gang_timeouts()
        both.assert_same_state()
        assert both.tsched.gang.waiting_count() == 0
        assert both.tstore.get("Pod", "w0", "ml").unschedulable
        assert both.tstore.get("Pod", "w0", "ml").unschedulable_message == (
            "gang formation timed out")
        # the freed reservation lets an ordinary pod through
        assert both.sched(PodDesc("solo", {"cpu": 2})).node == "n1"

    def test_partial_gang_counts_bound_members(self, monkeypatch):
        bound = gang_pod("w0", "job", 2, ns="ml", node="n1", phase="Running")
        both = Both(monkeypatch, [cpu_node("n1", 4)], pods=[bound])
        got = both.sched(gang_pod("w1", "job", 2, ns="ml"))
        assert got.decision == "bind" and both.node_of("w1", "ml") == "n1"

    def test_waiting_gang_member_not_marked_unschedulable(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 2)], gang_timeout=5)
        both.sched(gang_pod("w0", "job", 2, {"cpu": 2}, ns="ml"))
        # a retry while waiting runs no cycle against the pod's own claim
        assert both.reconcile("w0", "ml") is None
        pod = both.tstore.get("Pod", "w0", "ml")
        assert not pod.unschedulable and pod.node == ""

    def test_step_skips_waiting_members_and_binds_a_released_gang_once(self, monkeypatch):
        """The port's polled step: the waiting member is not cycled again,
        and the members a release binds are not cycled after it."""
        both = Both(monkeypatch, [cpu_node("n1", 4)])
        for i in range(3):
            both.create(gang_pod(f"w{i}", "job", 3, ns="ml"))
        assert both.tsched.step() == 3
        assert all(both.node_of(f"w{i}", "ml") == "n1" for i in range(3))
        assert both.tsched.assumed() == {}


class TestGoneWaitingMembers:
    """The port alone: a poll reaches only pods in the store, so step()
    drops the Permit claims of members deleted or recreated since they
    waited (the reference's delete event pops the claim), and takes them
    out of the gang's waiting set, where the reference leaves them."""

    def test_deleted_waiting_member_frees_its_node(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 2)])
        both.sched(gang_pod("w0", "job", 2, {"cpu": 2}, ns="ml"))
        assert both.tsched.assumed() == {"ml/w0": "n1"}
        both.tstore.delete("Pod", "w0", "ml")
        both.tsched.step()
        assert both.tsched.assumed() == {}
        assert both.tsched.gang.waiting_count() == 0
        assert both.tsched._node_infos()["n1"].requested().get("cpu", 0) == 0
        # the freed node takes an ordinary pod
        both.tstore.create(port_pod(PodDesc("solo", {"cpu": 2})))
        both.tsched.step()
        assert both.node_of("solo") == "n1"

    def test_recreated_member_is_cycled_again(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 4)])
        both.sched(gang_pod("w0", "job", 2, ns="ml"))
        old_uid = both.tstore.get("Pod", "w0", "ml").uid
        both.tstore.delete("Pod", "w0", "ml")
        both.tstore.create(port_pod(gang_pod("w0", "job", 2, ns="ml")))
        new_uid = both.tstore.get("Pod", "w0", "ml").uid
        assert new_uid != old_uid
        got = both.tsched.reconcile("w0", "ml")
        assert got is not None and got.decision == "wait"
        assert both.tsched._assumed["ml/w0"][0].uid == new_uid
        assert both.tsched.gang.waiting_count() == 1

    def test_deleted_member_does_not_count_as_arrived(self, monkeypatch):
        both = Both(monkeypatch, [cpu_node("n1", 8)])
        for i in range(2):
            both.sched(gang_pod(f"w{i}", "job", 3, ns="ml"))
        both.tstore.delete("Pod", "w0", "ml")
        both.tsched.step()
        both.tstore.create(port_pod(gang_pod("w2", "job", 3, ns="ml")))
        both.tsched.step()
        # two of three alive: the gang still waits, and binds none
        assert both.node_of("w1", "ml") == both.node_of("w2", "ml") == ""
        assert set(both.tsched.assumed()) == {"ml/w1", "ml/w2"}
        both.tstore.create(port_pod(gang_pod("w0", "job", 3, ns="ml")))
        assert both.tsched.step() == 3
        assert all(both.node_of(f"w{i}", "ml") == "n1" for i in range(3))


# ------------------------------------------------------------ test_gang_scale.py

class TestEightMemberGang:
    def test_binds_only_when_all_eight_fit(self, monkeypatch):
        both = Both(monkeypatch, [board(f"n{i}") for i in range(8)], gang_timeout=0.5)
        for i in range(7):
            assert both.sched(gang_pod(f"m{i}", "big", 8, {mig("7g.80gb"): 1})).decision == "wait"
        assert all(both.node_of(f"m{i}") == "" for i in range(7))
        got = both.sched(gang_pod("m7", "big", 8, {mig("7g.80gb"): 1}))
        assert got.decision == "bind"
        bound = [both.node_of(f"m{i}") for i in range(8)]
        assert all(bound) and len(set(bound)) == 8  # one GPU each

    def test_contention_starves_gang_until_capacity_frees(self, monkeypatch):
        squatter = PodDesc("squatter", {mig("7g.80gb"): 1}, node="n0", phase="Running")
        both = Both(monkeypatch, [board(f"n{i}") for i in range(8)], pods=[squatter],
                    gang_timeout=0.2)
        for i in range(8):
            both.sched(gang_pod(f"m{i}", "big", 8, {mig("7g.80gb"): 1}))
        # seven GPUs free: the gang cannot complete, and times out whole
        both.clock.t += 0.25
        both.reconcile("m0")  # drives the timeout sweep
        assert all(both.node_of(f"m{i}") == "" for i in range(8))
        both.delete("squatter")
        for i in range(8):
            both.reconcile(f"m{i}")
        assert all(both.node_of(f"m{i}") for i in range(8))


class TestTwoGangsRacingOneSlice:
    def test_one_wins_atomically_loser_unreserves(self, monkeypatch):
        both = Both(monkeypatch, [board("n0"), board("n1")], gang_timeout=0.2)
        for name, gang in (("a0", "alpha"), ("b0", "beta"), ("a1", "alpha"), ("b1", "beta")):
            both.sched(gang_pod(name, gang, 2, {mig("7g.80gb"): 1}))
        both.clock.t += 0.25
        for name in ("a0", "a1", "b0", "b1"):
            both.reconcile(name)
        alpha = [both.node_of(f"a{i}") for i in range(2)]
        beta = [both.node_of(f"b{i}") for i in range(2)]
        winner, loser = ("a", "b") if all(alpha) else ("b", "a")
        assert all(alpha) != all(beta)  # exactly one gang bound whole
        assert not any(alpha if loser == "a" else beta)  # the other holds nothing
        for i in range(2):
            both.set_phase(f"{winner}{i}", "default", PodPhase.SUCCEEDED)
        for i in range(2):
            both.reconcile(f"{loser}{i}")
        assert all(both.node_of(f"{loser}{i}") for i in range(2))


class TestGangPreemptionIncludesPendingMembers:
    def test_full_gang_evicted_with_unbound_member(self, monkeypatch):
        """An over-quota gang with a member still pending and unbound is
        evicted whole: the pending member would wait on a quorum that can
        never re-form."""
        members = [gang_pod(f"g{i}", "loadjob", 3, {mig("7g.80gb"): 1}, ns="team-a",
                            node=f"n{i}", phase="Running") for i in range(2)]
        members.append(gang_pod("g2", "loadjob", 3, {mig("7g.80gb"): 1}, ns="team-a"))
        for m in members:
            m.labels[CAPACITY_LABEL] = CAPACITY_OVER_QUOTA
        quotas = [QuotaDesc("team-a", min={GB: 0}, max={GB: 160}, name="eq-a"),
                  QuotaDesc("team-b", min={GB: 160}, max={GB: 160}, name="eq-b")]
        both = Both(monkeypatch, [board("n0"), board("n1")], pods=members, quotas=quotas)
        both.sched(PodDesc("claim", {mig("7g.80gb"): 1}, ns="team-b"))
        for _ in range(3):
            both.reconcile("claim", "team-b")
            if both.node_of("claim", "team-b"):
                break
        assert [p.name for p in both.tstore.list("Pod", namespace="team-a")] == []
        assert both.node_of("claim", "team-b")


# ------------------------------------------------------------ random arrivals

@pytest.mark.parametrize("seed", range(12))
def test_random_gang_arrivals_match_the_reference(monkeypatch, seed):
    """Gangs of 1-4 members and single pods arrive on cpu nodes and
    one-GPU MIG nodes, in random order, the clock moving between cycles
    past some gangs' timeouts, and members retried: every cycle and every
    pod's state agree."""
    rng = random.Random(9000 + seed)
    nodes = [board(f"m{i}") for i in range(rng.randint(1, 4))]
    nodes += [cpu_node(f"c{i}", rng.choice([2, 4])) for i in range(rng.randint(1, 3))]
    both = Both(monkeypatch, nodes, gang_timeout=rng.choice([0.5, 2.0]))
    arrivals = []
    for g in range(rng.randint(1, 4)):
        size = rng.randint(1, 4)
        request = rng.choice([{"cpu": 1}, {"cpu": 2}, {mig("7g.80gb"): 1}])
        arrivals += [gang_pod(f"g{g}-{i}", f"job{g}", size, request,
                              priority=rng.choice([0, 5])) for i in range(size)]
    arrivals += [PodDesc(f"solo{i}", rng.choice([{"cpu": 1}, {mig("7g.80gb"): 1}]))
                 for i in range(rng.randint(0, 3))]
    rng.shuffle(arrivals)
    created = []
    for desc in arrivals:
        both.sched(desc)
        created.append(desc.name)
        both.clock.t += rng.choice([0.0, 0.1, 0.3, 1.0])
        if rng.random() < 0.3:
            both.reconcile(rng.choice(created))
    for _ in range(2):
        both.clock.t += 1.0
        for name in created:
            both.reconcile(name)


# ------------------------------------------------------------ fault F6

MULTINODE = "nos.nebuly.com/multihost-topology"


def pool_board(name, pool):
    desc, advertised = board(name)
    desc.labels = {"cloud.google.com/gke-nodepool": pool}
    return desc, advertised


def f6_nodes():
    """pool-a: two free one-GPU nodes; pool-c: one free, one held by a
    squatter. A gang's first member takes the best-scored node, ties to
    the highest name: c0, in the pool without room for the rest."""
    nodes = [pool_board("a0", "pool-a"), pool_board("a1", "pool-a"),
             pool_board("c0", "pool-c"), pool_board("c1", "pool-c")]
    squatter = PodDesc("squatter", {mig("7g.80gb"): 1}, node="c1", phase="Running")
    return nodes, [squatter]


def multinode_member(name, gang, size):
    return gang_pod(name, gang, size, {mig("7g.80gb"): 1},
                    annotations={MULTINODE: f"{size}x1"})


def _rounds(reconcile, node_of, names, clock, rounds=3, timeout=0.5):
    """Cycle every member, then let the gang time out; the members'
    nodes after each round."""
    seen = []
    for _ in range(rounds):
        for name in names:
            reconcile(name)
        seen.append([node_of(name) for name in names])
        clock.t += timeout + 0.1
        reconcile(names[0])  # the timeout sweep
    return seen


def test_f6_reference_never_forms_the_gang_and_the_port_does(monkeypatch):
    """F6's input at small size: the reference's pin (unrepaired) puts the
    first member on c0 after every timeout, and the gang never forms; the
    port pins the whole gang to pool-a, which holds it, and binds it
    there at the first try."""
    from tests.torch_quota_cases import (
        Clock,
        drive_ref_time,
        ref_reconcile,
        ref_scheduler,
        stores,
    )
    from nos_tpu_torch.scheduler import Scheduler, new_framework

    nodes, pods = f6_nodes()
    clock = Clock()
    drive_ref_time(monkeypatch, clock)
    jstore, tstore = stores(nodes=nodes, pods=pods, clock=clock)
    names = ["m0", "m1"]
    for name in names:
        desc = multinode_member(name, "job", 2)
        desc.created = clock.t
        jstore.create(ref_pod(desc))
        tstore.create(port_pod(desc))
    jsched = ref_scheduler(jstore, gang_timeout=0.5, repair_f6=False)
    tsched = Scheduler(tstore, new_framework(tstore, 0.5))
    ref_rounds = _rounds(lambda n: ref_reconcile(jsched, n, "default"),
                         lambda n: jstore.get("Pod", n, "default").spec.node_name,
                         names, clock)
    assert ref_rounds == [["", ""]] * 3
    assert jsched.gang.waiting_count() == 0 or all(
        node == "c0" for _, node in jsched.gang.waiting_members("default/job"))
    for name in names:
        tsched.reconcile(name, "default")
    bound = {tstore.get("Pod", n, "default").node for n in names}
    assert bound == {"a0", "a1"}
    assert tsched.gang_timeouts == {}


def test_f6_gang_no_pool_holds_still_times_out_as_a_unit(monkeypatch):
    """A gang of three no pool holds (two nodes a pool): no pool pins it,
    its members wait, time out as a unit and never bind."""
    nodes = [pool_board("a0", "pool-a"), pool_board("a1", "pool-a"),
             pool_board("c0", "pool-c"), pool_board("c1", "pool-c")]
    both = Both(monkeypatch, nodes, gang_timeout=0.5)
    names = ["m0", "m1", "m2"]
    for name in names:
        both.sched(multinode_member(name, "big", 3))
    for _ in range(2):
        both.clock.t += 0.6
        for name in names:
            both.reconcile(name)
    assert all(both.node_of(n) == "" for n in names)
    assert both.tsched.gang_timeouts["default/big"] >= 2


def test_f6_input_matches_the_repaired_reference(monkeypatch):
    """The parity side: with F6 repaired on the reference's side
    (``RefMultihostIciFilter``), every cycle of the F6 input agrees,
    refusals and their messages included."""
    nodes, pods = f6_nodes()
    both = Both(monkeypatch, nodes, pods=pods, gang_timeout=0.5)
    for name in ("m0", "m1"):
        both.sched(multinode_member(name, "job", 2))
    assert {both.node_of("m0"), both.node_of("m1")} == {"a0", "a1"}
    # a later gang of one sees c0 alone in a pool that holds it
    got = both.sched(multinode_member("solo", "one", 1))
    assert got.decision == "bind" and both.node_of("solo") == "c0"


def test_f6_members_on_unlabelled_nodes_match_the_repaired_reference(monkeypatch):
    """Mixed labelled and unlabelled nodes: once a member waits on a node
    with no pool label, the whole-gang check is skipped on both sides
    (that member pins nothing), so the later members go to the
    best-scored nodes, whatever their pool, and the gang forms across
    them, every cycle agreeing."""
    nodes = [board("u0"), board("u1"), pool_board("a0", "pool-a"),
             pool_board("a1", "pool-a"), pool_board("c0", "pool-c")]
    both = Both(monkeypatch, nodes)
    for name in ("m0", "m1"):
        got = both.sched(multinode_member(name, "job", 3))
        assert got.decision == "wait"
    assert both.tsched.assumed() == {"default/m0": "u1", "default/m1": "u0"}
    got = both.sched(multinode_member("m2", "job", 3))
    assert got.decision == "bind"
    assert {n: both.node_of(n) for n in ("m0", "m1", "m2")} == {
        "m0": "u1", "m1": "u0", "m2": "c0"}
