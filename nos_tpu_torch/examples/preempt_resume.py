"""Preempt, checkpoint, resume on an H100 re-carved by MIG: the port of
``examples/preempt_resume.py``.

    python -m nos_tpu_torch.examples.preempt_resume [--device cpu]
    torchrun --nproc-per-node 4 -m nos_tpu_torch.examples.preempt_resume --device cpu

The reference boots its control plane over one TPU host and plays the
elastic-quota story: a trainer borrows the whole board, a guaranteed
claimant takes half, the trainer is preempted, the board re-carved, and
the trainer resumes from its checkpoint on the smaller slice. Here the
node is one H100 80GB, driven by the port's own pieces (the node store,
``MigNodeInitializer`` and ``MigPartitioner``, the MIG agent over
``SimMigClient`` with its device plugin), in three phases:

1. The trainer's pod asks for ``nvidia.com/mig-7g.80gb``. The new node
   gets its first geometry (one 7g.80gb), the agent carves it and
   acknowledges the plan, the pod is bound to it, and the trainer trains
   3 steps and checkpoints (``parallel/checkpoint.Checkpointer``).
2. The claimant's pod asks for ``nvidia.com/mig-3g.40gb``. The port has
   no scheduler, so the example preempts the trainer itself: it deletes
   the trainer's pod and submits its replacement, which asks for a
   3g.40gb too (half the GPU, as the reference's trainer resumes on half
   its chips). ``MigNode.update_geometry_for`` re-plans the GPU for both
   pending pods; the agent destroys the 7g.80gb, creates the new
   geometry (two 3g.40gb) and acknowledges the plan, and the device
   plugin advertises ``nvidia.com/mig-3g.40gb: 2``. The claimant is bound
   to the first instance.
3. The trainer's new pod is bound to the second 3g.40gb. It restores the
   checkpoint and trains 2 more steps.

The re-carve runs on the simulator: the MIG mode of the card's machine
is off, and the agent refuses an NVML client on such a GPU. The training
runs on the card: ``train_llama.card_config()`` (head_dim 64, flash +
remat, so each step launches the forward kernel twice a layer and the
two backward kernels once), with ``make_train_step``'s built-in momentum
SGD as the reference's, on [8, 16] tokens from a seed; on the CPU
``tiny_config`` with dense attention. In one process there is no mesh.
Under torchrun with W ranks (a multiple of 4) phase 1 trains on the
examples' (W/2, 2) mesh over every rank, and phase 3 resumes on a (W/4,
2) mesh over the first half of the ranks, as the reference goes from 8
devices to 4; the other half stop training there. Several ranks run
on the CPU only, over gloo: the example refuses them on the card. Every rank plays the same
node story: it is deterministic, so no rank waits on another for it.
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.controllers.migagent import build_migagent
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.device.sim import SimDevicePlugin, SimMigClient, SimMigPool, \
    SimPodResourcesClient
from nos_tpu_torch.examples import dp_tp_mesh, is_main_rank
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import (
    MIG_RESOURCE_PREFIX,
    PARTITIONING_LABEL,
    PARTITIONING_MIG,
    RESOURCE_GPU,
    mig_resource,
)
from nos_tpu_torch.kube.store import Node, NodeStore, Pod, PodPhase
from nos_tpu_torch.models.llama import init_llama_params, tiny_config
from nos_tpu_torch.partitioning.mig import MigNodeInitializer, MigPartitioner, mig_node

NODE = "h100-0"
TRAINER_PROFILE = "7g.80gb"
HALF_PROFILE = "3g.40gb"
TOKENS_SHAPE = (8, 16)
STEPS_BEFORE, STEPS_AFTER = 3, 2
MAX_AGENT_STEPS = 10


class GpuNodeSim:
    """One H100 node: the store, the simulated MIG hardware and device
    plugin, the node's MIG agent, and the control plane's partitioner
    and initializer. The example plays the scheduler (``bind``) and the
    preemption (``preempt``)."""

    def __init__(self) -> None:
        self.store = NodeStore()
        self.store.create(Node(NODE, labels={GPU_PRODUCT_LABEL: H100_80GB,
                                             PARTITIONING_LABEL: PARTITIONING_MIG},
                               capacity={RESOURCE_GPU: 1}, allocatable={RESOURCE_GPU: 1}))
        self.pool = SimMigPool()
        sim = SimMigClient(self.pool, NODE)
        client = GpuClient(sim, SimPodResourcesClient(self.store, NODE, sim.get_mig_devices))
        self.agent = build_migagent(self.store, NODE, client,
                                    SimDevicePlugin(self.store, self.pool))
        self.partitioner = MigPartitioner(self.store)
        plan_ids = itertools.count(1)
        self._plan_id: Callable[[], str] = lambda: str(next(plan_ids))
        self.initializer = MigNodeInitializer(self.partitioner, self._plan_id)

    def node(self) -> Node:
        return self.store.get("Node", NODE)

    def converge(self) -> float:
        """Step the agent until the status plan equals the spec plan;
        the seconds it took (spec to ack)."""
        t0 = time.perf_counter()
        for _ in range(MAX_AGENT_STEPS):
            self.agent.step()
            ann = self.node().annotations
            if ann.get(annot.STATUS_PARTITIONING_PLAN) == ann[annot.SPEC_PARTITIONING_PLAN]:
                return time.perf_counter() - t0
        raise RuntimeError(f"the MIG agent did not acknowledge plan "
                           f"{ann[annot.SPEC_PARTITIONING_PLAN]} in {MAX_AGENT_STEPS} steps")

    def submit(self, name: str, namespace: str, profile: str) -> None:
        self.store.create(Pod(name, namespace, request={mig_resource(profile): 1}))

    def bind(self, name: str, namespace: str) -> None:
        """Bind a pending pod to the node if its request fits the free
        instances the node reports, and report at once."""
        pod = self.store.get("Pod", name, namespace)
        if not mig_node(self.node()).add_pod(pod.request):
            raise RuntimeError(f"pod {namespace}/{name} ({pod.request}) does not fit "
                               f"{NODE}'s free MIG instances")

        def run(p: Pod) -> None:
            p.node, p.phase = NODE, PodPhase.RUNNING

        self.store.patch_merge("Pod", name, namespace, run)
        self.agent.reporter.reconcile()

    def preempt(self, name: str, namespace: str) -> None:
        self.store.delete("Pod", name, namespace)
        self.agent.reporter.reconcile()

    def replan(self) -> Dict[int, Dict[str, int]]:
        """Re-carve for the pending pods: what they ask for beyond the
        node's free instances, through ``MigNode.update_geometry_for``;
        the chosen geometry is written as a new plan."""
        gpu_node = mig_node(self.node())
        free = gpu_node.free_slices()
        demand: Dict[str, int] = {}
        for pod in self.store.list("Pod"):
            if not pod.node and pod.phase == PodPhase.PENDING:
                for name, qty in pod.request.items():
                    demand[name] = demand.get(name, 0) + int(qty)
        lacking = {name: qty - free.get(name[len(MIG_RESOURCE_PREFIX):], 0)
                   for name, qty in demand.items() if name.startswith(MIG_RESOURCE_PREFIX)}
        if not gpu_node.update_geometry_for({n: q for n, q in lacking.items() if q > 0}):
            raise RuntimeError(f"no geometry of {NODE} serves {lacking}")
        geometry = gpu_node.geometry()
        self.partitioner.apply_partitioning(NODE, self._plan_id(), geometry)
        return geometry

    def snapshot(self) -> dict:
        node = self.node()
        _, status = annot.parse_node_annotations(node.annotations)
        used: Dict[int, Dict[str, int]] = {}
        for s in status:
            if s.status == annot.STATUS_USED:
                used.setdefault(s.gpu_index, {})[s.profile] = s.quantity
        return {"allocatable": dict(node.allocatable),
                "status": annot.status_geometries(status), "used": used,
                "spec_plan": node.annotations.get(annot.SPEC_PARTITIONING_PLAN),
                "status_plan": node.annotations.get(annot.STATUS_PARTITIONING_PLAN),
                "instances": self.pool.geometry(NODE)}


def trainer_config(device: torch.device):
    from nos_tpu_torch.examples.train_llama import card_config

    return card_config() if device.type == "cuda" else \
        tiny_config(attention="dense", remat=False)


def batch_tokens(config) -> np.ndarray:
    return np.random.default_rng(1).integers(0, config.vocab_size, TOKENS_SHAPE)


def half_mesh(device: torch.device):
    """(mesh, in_mesh): the resumed trainer's (W/4, 2) mesh over the
    first W/2 ranks, and whether this rank is in it; (None, True) in one
    process. Every rank builds the mesh, since its groups are made
    together."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return None, True
    mesh = DeviceMesh(device.type, torch.arange(world // 2).reshape(world // 4, 2),
                      mesh_dim_names=("dp", "tp"))
    return mesh, dist.get_rank() < world // 2


def _whole(state, mesh, config) -> list:
    """Host copies of a train state's (params, velocity) leaves, gathered
    whole under a mesh (a collective over the mesh's ranks)."""
    from nos_tpu_torch.models.llama import tree_leaves
    from nos_tpu_torch.parallel.sharding import gather_params

    trees = state if mesh is None else [gather_params(t, mesh, config) for t in state]
    return [t.detach().to("cpu", copy=True) for tree in trees for t in tree_leaves(tree)]


def train_steps(config, state_fn, tokens: np.ndarray, steps, mesh, device, losses):
    """Run ``steps`` (step numbers) of ``make_train_step(mesh, ...)``'s
    built-in momentum SGD from ``state_fn(shard_state)``, the loss of
    each into ``losses``; returns the state."""
    from nos_tpu_torch.parallel.sharding import llama_data_sharding
    from nos_tpu_torch.parallel.train import make_train_step

    train_step, shard_state = make_train_step(mesh, config, device=device)
    state = state_fn(shard_state)
    block = llama_data_sharding(mesh, torch.from_numpy(tokens)).to(device)
    for step in steps:
        state, loss = train_step(state, block)
        losses[step] = float(loss)
    return state


def uninterrupted_losses(config, params, tokens: np.ndarray, device) -> Dict[int, float]:
    """The same steps, 1 to STEPS_BEFORE + STEPS_AFTER, in one process
    with no preemption: what the resumed steps are held against."""
    losses: Dict[int, float] = {}
    train_steps(config, lambda shard: shard(params, donate=True), tokens,
                range(1, STEPS_BEFORE + STEPS_AFTER + 1), None, device, losses)
    return losses


def run(config, params, tokens: np.ndarray, ckpt_dir: str, device, mesh=None, say=print,
        outputs: Optional[dict] = None) -> dict:
    """The three phases on ``params`` (whole, donated) and ``tokens``
    [8, 16], phase 1 on ``mesh`` (the examples' ``dp_tp_mesh``).
    ``outputs``, if given, receives the state saved at step 3 and the
    state restored from it, whole, as host tensors."""
    from nos_tpu_torch.parallel.checkpoint import Checkpointer

    node = GpuNodeSim()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and world % 4:
        raise ValueError(f"the resumed trainer takes half the ranks as a (W/4, 2) mesh: "
                         f"W must be a multiple of 4, not {world}")
    if world > 1 and device.type != "cpu":
        # the checkpoint's host copy of the half mesh would need a group
        # made by every rank, which the ranks left out never join
        raise ValueError("several ranks run this example on the CPU (gloo); on the card it "
                         "runs in one process")
    losses: Dict[int, float] = {}
    ack_ms = []

    # ---- 1: a new node, its first geometry; the trainer trains and saves
    node.submit("train", "trainer", TRAINER_PROFILE)
    if not node.initializer.is_initialized(node.node()):
        node.initializer.init_node_partitioning(node.node())
    ack_ms.append(1e3 * node.converge())
    node.bind("train", "trainer")
    phase1 = node.snapshot()
    say(f"[1] node {NODE}: {phase1['instances']}, plan {phase1['status_plan']} "
        f"acknowledged in {ack_ms[0]:.2f} ms; the trainer's pod is bound to the "
        f"{TRAINER_PROFILE} instance")
    state = train_steps(config, lambda shard: shard(params, donate=True), tokens,
                        range(1, STEPS_BEFORE + 1), mesh, device, losses)
    for step in range(1, STEPS_BEFORE + 1):
        say(f"    step {step}: loss {losses[step]:.4f}  "
            f"({'one device' if mesh is None else f'mesh {tuple(mesh.shape)}'})")
    with Checkpointer(ckpt_dir, mesh=mesh) as ckpt:
        ckpt.save(STEPS_BEFORE, state, force=True)
        ckpt.wait()
    if outputs is not None:
        outputs["saved"] = _whole(state, mesh, config)
    del state
    say(f"[1] checkpoint saved at step {STEPS_BEFORE}")

    # ---- 2: the claimant arrives; the trainer is preempted, the GPU re-carved
    node.submit("claim", "claimant", HALF_PROFILE)
    node.preempt("train", "trainer")
    node.submit("train-resume", "trainer", HALF_PROFILE)
    chosen = node.replan()
    ack_ms.append(1e3 * node.converge())
    node.bind("claim", "claimant")
    phase2 = node.snapshot()
    say(f"[2] the trainer was preempted; {NODE} re-carved to {phase2['instances']}, plan "
        f"{phase2['status_plan']} acknowledged in {ack_ms[1]:.2f} ms; the claimant's pod "
        f"is bound to a {HALF_PROFILE}")

    # ---- 3: the trainer's new pod takes the other half and resumes
    node.bind("train-resume", "trainer")
    phase3 = node.snapshot()
    say(f"[3] the trainer's new pod is bound to the other {HALF_PROFILE}")
    small, in_mesh = half_mesh(device)
    resumed_from = None
    if in_mesh:
        def restore(shard):
            nonlocal resumed_from
            like = shard(init_llama_params(config, seed=7, device=device), donate=True)
            with Checkpointer(ckpt_dir, mesh=small) as ckpt:
                restored, resumed_from = ckpt.restore(like)
            if outputs is not None:
                outputs["restored"] = _whole(restored, small, config)
            return restored

        train_steps(config, restore, tokens,
                    range(STEPS_BEFORE + 1, STEPS_BEFORE + STEPS_AFTER + 1), small, device,
                    losses)
        for step in range(STEPS_BEFORE + 1, STEPS_BEFORE + STEPS_AFTER + 1):
            say(f"    step {step}: loss {losses[step]:.4f}  "
                f"({'one device' if small is None else f'mesh {tuple(small.shape)}'}, resumed)")
        say(f"[3] training continued from the step-{resumed_from} checkpoint on the "
            f"{HALF_PROFILE} instance")
    return {
        "world": world,
        "mesh_before": None if mesh is None else list(mesh.shape),
        "mesh_after": None if small is None else list(small.shape),
        "in_resumed_mesh": in_mesh,
        "config": {"d_model": config.d_model, "n_layers": config.n_layers,
                   "head_dim": config.head_dim, "attention": config.attention,
                   "remat": config.remat},
        "losses": losses,
        "saved_step": STEPS_BEFORE,
        "resumed_from": resumed_from,
        "recarve_chosen": chosen,
        "spec_to_ack_ms": ack_ms,
        "node": {"phase1": phase1, "phase2": phase2, "phase3": phase3},
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint directory (default: a new one)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    from nos_tpu_torch.examples.train_llama import _shared_dir

    args = parser().parse_args(argv)
    device = _resolve_device(args.device)
    mesh = dp_tp_mesh(device)
    config = trainer_config(device)
    say = print if is_main_rank() else (lambda *a, **k: None)
    ckpt_dir = _shared_dir(args.ckpt_dir)
    out = run(config, init_llama_params(config, seed=0, device=device), batch_tokens(config),
              ckpt_dir, device, mesh, say)
    out["ckpt_dir"] = ckpt_dir
    return out


if __name__ == "__main__":
    main()
