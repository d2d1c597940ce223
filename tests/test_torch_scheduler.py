"""The vanilla scheduler (nos_tpu_torch.scheduler) against nos_tpu.scheduler.

Exact, on translated cases (tests/torch_planner_cases.py: a v5e node
with one 2x4 board per GPU ↔ an H100 node, slice resources ↔ MIG
instances of as many memory slices): nodes advertising slices, tainted,
cordoned or labelled, running pods, and a pending pod with requests,
tolerations and a node selector. Each filter's status (code, plugin,
message with its resource names translated), the taint score, and the
whole cycle: the node chosen, the Unschedulable condition's message and
the diagnosis's counts per (plugin, message). Both sides run their
default wiring (``new_framework``: quota, gangs, the pool pin, the drain
reservation and the topology, taint, spread and grace scores; with no
quota, gang, pool or reservation in these cases, the filters that count
are the seven vanilla predicates, and the topology score steers).
"""
import random

import pytest

from nos_tpu.kube.store import KubeStore
from nos_tpu.scheduler import framework as jfw
from nos_tpu_torch.kube.store import NodeStore, PodPhase
from nos_tpu_torch.scheduler import Scheduler, framework as tfw
from tests.torch_quota_cases import grouped, ref_cycle, ref_scheduler
from tests.torch_planner_cases import (
    MIG_PROFILES,
    NodeDesc,
    PodDesc,
    port_node,
    port_pod,
    ref_node,
    ref_pod,
    same_tables,
    to_port_resource,
    to_ref_resource,
    translate_text,
)

FILTERS = [(jfw.NodeUnschedulableFit, tfw.NodeUnschedulableFit),
           (jfw.TaintTolerationFit, tfw.TaintTolerationFit),
           (jfw.NodeSelectorFit, tfw.NodeSelectorFit),
           (jfw.NodeResourcesFit, tfw.NodeResourcesFit)]


@pytest.fixture(autouse=True)
def tables():
    with same_tables():
        yield


def mig(profile):
    return f"nvidia.com/mig-{profile}"


def nodes_both(desc: NodeDesc, advertised):
    jn, tn = ref_node(desc), port_node(desc)
    jn.status.allocatable.update({to_ref_resource(k): v for k, v in advertised.items()})
    tn.allocatable.update(advertised)
    return jn, tn


def random_case(rng):
    nodes = []
    for i in range(rng.randint(1, 5)):
        desc = NodeDesc(f"n{i}", gpus=2, labels={"pool": rng.choice("ab")})
        roll = rng.random()
        if roll < 0.2:
            desc.taints = [("dedicated", "x", "NoSchedule")]
        elif roll < 0.35:
            desc.taints = [("soft", "", "PreferNoSchedule")]
        elif roll < 0.45:
            desc.taints = [("evict", "y", "NoExecute")]
        desc.unschedulable = rng.random() < 0.1
        advertised = {mig(p): rng.randint(0, 2) for p in rng.sample(MIG_PROFILES, 2)}
        nodes.append((desc, advertised))
    running = []
    for desc, advertised in nodes:
        for name, qty in advertised.items():
            if qty and rng.random() < 0.4:
                running.append(PodDesc(f"run-{desc.name}-{name[-7:]}", {name: 1}, ns="run",
                                       node=desc.name, phase="Running"))
    request = {mig(rng.choice(MIG_PROFILES)): rng.randint(1, 2)}
    if rng.random() < 0.3:
        request["cpu"] = rng.choice([1, 9])
    pod = PodDesc("p", request, ns="ml")
    if rng.random() < 0.4:
        pod.tolerations = [rng.choice([("dedicated", "Equal", "x", "NoSchedule"),
                                       ("", "Exists", "", ""),
                                       ("node.kubernetes.io/unschedulable", "Exists", "", ""),
                                       ("soft", "Exists", "", "PreferNoSchedule"),
                                       ("evict", "Equal", "z", "")])]
    if rng.random() < 0.3:
        pod.selector = {"pool": rng.choice("ab")}
    return nodes, running, pod


def infos(nodes, running):
    out = []
    for desc, advertised in nodes:
        jn, tn = nodes_both(desc, advertised)
        on = [p for p in running if p.node == desc.name]
        out.append((jfw.NodeInfo(node=jn, pods=[ref_pod(p) for p in on]),
                    tfw.NodeInfo(node=tn, pods=[port_pod(p) for p in on])))
    return out


def status_of(status):
    return status.code, status.plugin, translate_text(status.message)


@pytest.mark.parametrize("seed", range(25))
def test_filters_and_score_match_the_reference(seed):
    rng = random.Random(5000 + seed)
    nodes, running, pod = random_case(rng)
    jpod, tpod = ref_pod(pod), port_pod(pod)
    for jinfo, tinfo in infos(nodes, running):
        assert ({k: v for k, v in tinfo.available().items() if k != "nvidia.com/gpu"}
                == {to_port_resource(k): v for k, v in jinfo.available().items()
                    if k != "google.com/tpu"})
        for jcls, tcls in FILTERS:
            assert tcls.name == jcls.name
            want = jcls().filter(jfw.CycleState(), jpod, jinfo)
            got = tcls().filter(tfw.CycleState(), tpod, tinfo)
            assert (got.code, got.message) == (want.code, translate_text(want.message))
        assert (tfw.TaintTolerationScoring().score(tfw.CycleState(), tpod, tinfo)
                == jfw.TaintTolerationScoring().score(jfw.CycleState(), jpod, jinfo))


def stores(nodes, running, pods):
    jstore, tstore = KubeStore(), NodeStore()
    for desc, advertised in nodes:
        jn, tn = nodes_both(desc, advertised)
        jstore.create(jn)
        tstore.create(tn)
    for p in list(running) + list(pods):
        jstore.create(ref_pod(p))
        tstore.create(port_pod(p))
    return jstore, tstore


def schedulers(jstore, tstore):
    return ref_scheduler(jstore), Scheduler(tstore)


@pytest.mark.parametrize("seed", range(40))
def test_cycle_matches_the_reference(seed):
    rng = random.Random(6000 + seed)
    nodes, running, pod = random_case(rng)
    jstore, tstore = stores(nodes, running, [pod])
    jsched, tsched = schedulers(jstore, tstore)
    jpod, tpod = jstore.get("Pod", "p", "ml"), tstore.get("Pod", "p", "ml")
    want, got = ref_cycle(jsched, jpod), tsched.schedule_one(tpod)
    assert (got.decision, got.node) == (want.decision, want.node)
    assert grouped(got.diagnosis) == grouped(want.diagnosis)
    if want.diagnosis is not None:
        assert got.diagnosis.num_nodes == want.diagnosis.num_nodes
    jpod, tpod = jstore.get("Pod", "p", "ml"), tstore.get("Pod", "p", "ml")
    assert tpod.node == jpod.spec.node_name
    assert tpod.unschedulable == jpod.unschedulable()
    conditions = [c for c in jpod.status.conditions if c.reason == "Unschedulable"]
    assert tpod.unschedulable_message == (translate_text(conditions[0].message)
                                          if conditions else "")


def test_binds_to_fitting_node_and_marks_the_rest():
    nodes = [(NodeDesc("small"), {mig("1g.10gb"): 1}), (NodeDesc("big"), {mig("7g.80gb"): 1})]
    pods = [PodDesc("fits", {mig("7g.80gb"): 1}), PodDesc("never", {mig("4g.40gb"): 1})]
    jstore, tstore = stores(nodes, [], pods)
    jsched, tsched = schedulers(jstore, tstore)
    for name in ("fits", "never"):
        ref_cycle(jsched, jstore.get("Pod", name, "default"))
    assert tsched.step() == 1
    assert tstore.get("Pod", "fits", "default").node == "big"
    never = tstore.get("Pod", "never", "default")
    jnever = jstore.get("Pod", "never", "default")
    assert never.unschedulable and jnever.unschedulable()
    assert never.unschedulable_message == translate_text(jnever.status.conditions[-1].message)
    assert never.unschedulable_message == (
        "0/2 nodes are available: 2 insufficient nvidia.com/mig-4g.40gb: requested 1, "
        "available 0.")


def test_step_orders_by_priority_and_skips_bound_and_foreign_pods():
    store = NodeStore()
    _, node = nodes_both(NodeDesc("n"), {mig("7g.80gb"): 1})
    store.create(node)
    store.create(port_pod(PodDesc("low", {mig("7g.80gb"): 1})))
    store.create(port_pod(PodDesc("high", {mig("7g.80gb"): 1}, priority=5)))
    foreign = port_pod(PodDesc("foreign", {mig("7g.80gb"): 1}, priority=9))
    foreign.scheduler_name = "default-scheduler"
    store.create(foreign)
    sched = Scheduler(store, scheduler_name="nos-scheduler")
    for p in ("low", "high"):
        store.patch_merge("Pod", p, "default",
                          lambda pod: setattr(pod, "scheduler_name", "nos-scheduler"))
    assert sched.step() == 1
    assert store.get("Pod", "high", "default").node == "n"
    assert store.get("Pod", "low", "default").unschedulable
    assert not store.get("Pod", "foreign", "default").unschedulable  # not ours
    assert sched.step() == 0  # marked once: no churn, and the bound pod is left alone


def test_a_node_clearing_up_binds_a_marked_pod():
    store = NodeStore()
    _, node = nodes_both(NodeDesc("n"), {})
    store.create(node)
    store.create(port_pod(PodDesc("p", {mig("3g.40gb"): 1})))
    sched = Scheduler(store)
    assert sched.step() == 0 and store.get("Pod", "p", "default").unschedulable
    store.patch_merge("Node", "n", "", lambda n: n.allocatable.update({mig("3g.40gb"): 1}))
    assert sched.step() == 1
    pod = store.get("Pod", "p", "default")
    assert pod.node == "n" and not pod.unschedulable and pod.unschedulable_message == ""
    assert pod.phase == PodPhase.PENDING  # the kubelet runs it


def test_start_and_stop_run_the_steps_on_a_thread():
    import time

    store = NodeStore()
    _, node = nodes_both(NodeDesc("n"), {mig("1g.10gb"): 1})
    store.create(node)
    store.create(port_pod(PodDesc("p", {mig("1g.10gb"): 1})))
    sched = Scheduler(store, interval=0.01)
    sched.start()
    try:
        deadline = time.monotonic() + 5
        while not store.get("Pod", "p", "default").node and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sched.stop()
    assert store.get("Pod", "p", "default").node == "n" and sched.error is None


def test_diagnosis_message_groups_most_frequent_first():
    d = tfw.Diagnosis(pod="ns/p", num_nodes=3, node_statuses={
        "a": tfw.Status.unschedulable("x", "P"), "b": tfw.Status.unschedulable("x", "P"),
        "c": tfw.Status.unschedulable("y", "Q")})
    assert d.aggregate_message() == "0/3 nodes are available: 2 x, 1 y."
    assert tfw.Diagnosis(num_nodes=0).aggregate_message() == (
        "0/0 nodes are available: no nodes.")


class _Recorder:
    """A PostFilter that nominates ``node`` (or nothing) and records what
    it was given."""

    name = "Recorder"

    def __init__(self, node=None):
        self.node, self.calls = node, []

    def post_filter(self, state, pod, filtered_nodes):
        self.calls.append((pod.name, {n: (s.plugin, s.message)
                                      for n, s in filtered_nodes.items()}))
        return self.node


class _RejectPre:
    name = "RejectPre"

    def pre_filter(self, state, pod):
        if pod.name.startswith("quota"):
            return tfw.Status.unschedulable("refused", self.name)
        return tfw.Status.ok()


def test_post_filter_runs_after_a_pre_filter_or_filter_rejection():
    store = NodeStore()
    for name in ("a", "b"):
        store.create(nodes_both(NodeDesc(name), {})[1])
    for name in ("quota-p", "fit-p"):
        store.create(port_pod(PodDesc(name, {mig("1g.10gb"): 1})))
    recorder = _Recorder()
    framework = tfw.Framework(pre_filter_plugins=[_RejectPre()],
                              filter_plugins=tfw.vanilla_filter_plugins(),
                              post_filter_plugins=[recorder])
    sched = Scheduler(store, framework)
    assert sched.capacity is None
    assert sched.step() == 0
    no_slice = ("NodeResourcesFit", "insufficient nvidia.com/mig-1g.10gb: requested 1, "
                                    "available 0")
    assert recorder.calls == [
        ("fit-p", {"a": no_slice, "b": no_slice}),
        ("quota-p", {"a": ("RejectPre", "refused"), "b": ("RejectPre", "refused")})]
    assert store.get("Pod", "quota-p", "default").unschedulable_message == (
        "0/2 nodes are available: 2 refused.")


def test_a_nominated_pod_failing_again_is_handed_back_to_the_partitioner():
    from nos_tpu_torch.controllers.partitioner import could_help

    store = NodeStore()
    store.create(nodes_both(NodeDesc("a"), {})[1])
    store.create(port_pod(PodDesc("p", {mig("3g.40gb"): 1})))
    framework = tfw.Framework(filter_plugins=tfw.vanilla_filter_plugins(),
                              post_filter_plugins=[_Recorder("a")])
    outcome = Scheduler(store, framework).schedule_one(store.get("Pod", "p", "default"))
    assert (outcome.decision, outcome.node) == ("nominate", "a")
    pod = store.get("Pod", "p", "default")
    assert pod.nominated_node == "a" and not could_help(pod)
    # the room the nomination counted on never came: the nomination goes
    Scheduler(store).schedule_one(pod)
    pod = store.get("Pod", "p", "default")
    assert pod.nominated_node == "" and pod.unschedulable and could_help(pod)


def test_new_framework_wires_the_reference_plugins():
    from nos_tpu.scheduler.scheduler import new_framework as jnew

    from nos_tpu_torch.scheduler import new_framework
    from tests.torch_planner_cases import PLUGIN_NAMES

    jframe, _, _ = jnew(KubeStore())
    tframe = new_framework(NodeStore())
    for point in ("pre_filter_plugins", "filter_plugins", "post_filter_plugins",
                  "reserve_plugins", "permit_plugins", "score_plugins"):
        assert [p.name for p in getattr(tframe, point)] == [
            PLUGIN_NAMES.get(p.name, p.name) for p in getattr(jframe, point)], point
