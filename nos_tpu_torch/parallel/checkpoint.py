"""Checkpoint and resume for sharded training state.

Counterpart of ``nos_tpu/parallel/checkpoint.py`` (orbax), built on
``torch.distributed.checkpoint``. The workloads the control plane
schedules are preemptible by design (over-quota training gangs are
evicted), so a training loop saves its sharded state and restores it
onto whatever mesh it lands on next, another shape included.

Each rank's shards become ``DTensor``s on a CPU twin of the mesh, with
placements from the sharding rules (``sharding.tree_rules``: an axis
named in a leaf's spec is ``Shard(dim)``, every other axis
``Replicate()``). The copy to host memory happens inside the save, as
orbax stages device arrays, so a gloo group never moves card memory and
the training step may go on mutating the state while an async save
writes. Restoring into the state of another mesh (``shard_state`` of
``make_train_step(other_mesh, ...)``) reads, for each rank, the pieces
its new shards overlap: resharding on restore, with no gather of the
whole tree anywhere. ``mesh=None`` saves or restores whole tensors on
one device (no process group needed).

State is the trainer's: ``(params, velocity)`` (the velocity shards
like the params) or ``(params, optimizer)``, a ``torch.optim``
optimizer whose param-shaped state shards like its param and whose
scalars (step counts) replicate.

Contracts kept from the reference: checkpoints live in ``path/<step>/``
(written under ``path/<step>.partial/`` and renamed when every rank has
written, so a half-written step is never the latest); saving a step at
or below the latest raises ``RuntimeError`` unless ``force``; restoring
from a missing checkpoint raises ``FileNotFoundError`` and creates no
directory.
"""
from __future__ import annotations

import os
import shutil
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from nos_tpu_torch.models.llama import tree_leaves
from nos_tpu_torch.parallel.sharding import rule_leaves, tree_rules

TrainState = Tuple[Any, Any]  # (params, velocity or optimizer)

_PARTIAL = ".partial"


# ------------------------------------------------------------ the layout


_CPU_MESHES: Dict[Any, Any] = {}


def _cpu_mesh(mesh):
    """The mesh's twin over the same ranks for host tensors (a
    collective the first time: every rank builds it together)."""
    if mesh.device_type == "cpu":
        return mesh
    if mesh not in _CPU_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _CPU_MESHES[mesh] = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    return _CPU_MESHES[mesh]


def _global_shape(local: torch.Tensor, spec, mesh):
    from nos_tpu_torch.parallel.mesh import axis_size

    return torch.Size(n * (axis_size(mesh, axis) if axis else 1)
                      for n, axis in zip(local.shape, spec))


def _wrap(local: torch.Tensor, spec, mesh, cpu_mesh):
    """A host copy of ``local`` as the DTensor of its spec (the tensor
    itself on one device)."""
    host = local.detach().to("cpu", copy=True)
    if mesh is None:
        return host
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(spec.index(name)) if name in spec else Replicate()
                  for name in mesh.mesh_dim_names]
    shape = _global_shape(host, spec, mesh)
    return DTensor.from_local(host, cpu_mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _layout(state: TrainState, mesh):
    """(specs of the params' leaves in ``tree_leaves`` order, the CPU
    mesh or None)."""
    params, _ = state
    specs = rule_leaves(tree_rules(params, mesh)) if mesh is not None else \
        [None] * len(tree_leaves(params))
    return specs, (_cpu_mesh(mesh) if mesh is not None else None)


def _state_dict(state: TrainState, mesh) -> Dict[str, Any]:
    """The flat DCP state dict of a train state: ``params/<i>`` and
    ``opt/<i>`` (velocity) or ``opt/<i>/<name>`` (optimizer state), each
    a host copy of the rank's shard."""
    params, opt = state
    specs, cpu_mesh = _layout(state, mesh)
    leaves = tree_leaves(params)
    out = {f"params/{i}": _wrap(p, s, mesh, cpu_mesh)
           for i, (p, s) in enumerate(zip(leaves, specs))}
    if isinstance(opt, torch.optim.Optimizer):
        index = {id(p): i for i, p in enumerate(leaves)}
        for p, entry in opt.state.items():
            i = index[id(p)]
            for name, value in entry.items():
                if not isinstance(value, torch.Tensor):
                    value = torch.tensor(value)
                if value.dim() and value.shape == p.shape:
                    out[f"opt/{i}/{name}"] = _wrap(value, specs[i], mesh, cpu_mesh)
                else:
                    out[f"opt/{i}/{name}"] = value.detach().to("cpu", copy=True)
    else:
        for i, (v, s) in enumerate(zip(tree_leaves(opt), specs)):
            out[f"opt/{i}"] = _wrap(v, s, mesh, cpu_mesh)
    return out


def _target_dict(shard_like: TrainState, mesh, metadata) -> Dict[str, Any]:
    """The state dict DCP loads into: ``shard_like``'s leaves (host
    DTensors of its own layout) and, for an optimizer, every entry the
    checkpoint holds for its params, param-shaped ones laid out like the
    param."""
    params, opt = shard_like
    if not isinstance(opt, torch.optim.Optimizer):
        return _state_dict(shard_like, mesh)
    specs, cpu_mesh = _layout(shard_like, mesh)
    leaves = tree_leaves(params)
    out = {f"params/{i}": _wrap(p, s, mesh, cpu_mesh)
           for i, (p, s) in enumerate(zip(leaves, specs))}
    for key, meta in metadata.state_dict_metadata.items():
        if not key.startswith("opt/"):
            continue
        i = int(key.split("/")[1])
        p, spec = leaves[i], specs[i]
        whole = _global_shape(p, spec, mesh) if mesh is not None else p.shape
        dtype = meta.properties.dtype
        if meta.size == whole and len(whole):
            out[key] = _wrap(torch.zeros(p.shape, dtype=dtype), spec, mesh, cpu_mesh)
        else:
            out[key] = torch.zeros(meta.size, dtype=dtype)
    return out


def _fill(shard_like: TrainState, loaded: Dict[str, Any]) -> TrainState:
    """Copy what DCP loaded into ``shard_like``'s own tensors (on their
    device), and the optimizer's state into the optimizer."""
    params, opt = shard_like

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    leaves = tree_leaves(params)
    with torch.no_grad():
        for i, p in enumerate(leaves):
            p.copy_(local(loaded[f"params/{i}"]))
        if not isinstance(opt, torch.optim.Optimizer):
            for i, v in enumerate(tree_leaves(opt)):
                v.copy_(local(loaded[f"opt/{i}"]))
            return shard_like
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in loaded.items():
        if key.startswith("opt/"):
            _, i, name = key.split("/")
            state.setdefault(int(i), {})[name] = local(value)
    groups = opt.state_dict()["param_groups"]
    opt.load_state_dict({"state": state, "param_groups": groups})
    return shard_like


# ---------------------------------------------------------- the directory


def _step_dirs(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(name) for name in os.listdir(path) if name.isdigit())


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path``, or None."""
    steps = _step_dirs(os.path.abspath(path))
    return steps[-1] if steps else None


def _rank0(mesh) -> bool:
    """Whether this rank is the mesh's first (it commits a save)."""
    return mesh is None or not dist.is_initialized() or \
        dist.get_rank() == int(mesh.mesh.flatten()[0])


def _mesh_ranks(mesh):
    return sorted(int(r) for r in mesh.mesh.flatten())


def _write(path: str, step: int, sd: Dict[str, Any], mesh, group, force: bool,
           max_to_keep: Optional[int]) -> None:
    """Write ``sd`` as step ``step`` under ``path`` and commit it (every
    rank calls it; rank 0 renames once all have written)."""
    import torch.distributed.checkpoint as dcp

    final = os.path.join(path, str(step))
    partial = final + _PARTIAL
    no_dist = mesh is None
    if _rank0(mesh):
        shutil.rmtree(partial, ignore_errors=True)
        os.makedirs(partial)
    if not no_dist:
        dist.barrier(group=group)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.save(sd, storage_writer=dcp.FileSystemWriter(partial), process_group=group,
                 no_dist=no_dist)
    if not no_dist:
        dist.barrier(group=group)
    if _rank0(mesh):
        if force and os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(partial, final)
        if max_to_keep is not None:
            for old in _step_dirs(path)[:-max_to_keep]:
                shutil.rmtree(os.path.join(path, str(old)), ignore_errors=True)
    if not no_dist:
        dist.barrier(group=group)


def _check_step(path: str, step: int, latest: Optional[int], force: bool) -> None:
    if latest is not None and step <= latest and not force:
        raise RuntimeError(
            f"checkpoint save skipped for step {step} under {path} "
            f"(latest is {latest}; pass force=True to overwrite)"
        )


def save_checkpoint(path: str, state: TrainState, step: int, *, mesh=None,
                    force: bool = False) -> None:
    """One synchronous save of ``state`` (the rank's shards on ``mesh``;
    every rank of the mesh calls it) at ``step`` under ``path/<step>/``.
    A training loop holds a ``Checkpointer`` instead, so saves overlap
    the steps. A step at or below the latest raises unless ``force``."""
    path = os.path.abspath(path)
    _check_step(path, step, latest_step(path), force)
    _write(path, step, _state_dict(state, mesh), mesh, None, force, None)


def restore_checkpoint(path: str, shard_like: TrainState, step: Optional[int] = None,
                       *, mesh=None, group=None) -> Tuple[TrainState, int]:
    """Restore ``(state, step)`` from ``path/<step>/`` (the latest by
    default) into ``shard_like``: a train state laid out on ``mesh``,
    e.g. ``make_train_step(mesh, ...)[1](params)``, whose tensors are
    overwritten in place and returned. Each rank reads only what its
    shards overlap, whatever mesh saved them. Every rank of ``group``
    (the default group unless given: a mesh over part of the ranks
    passes a group of its own ranks) calls it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        # building the reader would not create it, but say so early
        raise FileNotFoundError(f"no checkpoint under {path}")
    if step is None:
        step = latest_step(path)
    if step is None or not os.path.isdir(os.path.join(path, str(step))):
        raise FileNotFoundError(f"no checkpoint under {path}")
    reader = dcp.FileSystemReader(os.path.join(path, str(step)))
    target = _target_dict(shard_like, mesh, reader.read_metadata())
    with warnings.catch_warnings():
        # one device: DCP warns that it loads in one process, as asked
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.load(target, storage_reader=reader, process_group=group, no_dist=mesh is None)
    return _fill(shard_like, target), step


class Checkpointer:
    """Long-lived saver for a training loop: ``save`` copies the rank's
    shards to host memory and returns; the write runs on a thread of its
    own over a gloo group of its own (the step's collectives never meet
    it), one save at a time. The loop blocks only in ``wait()`` /
    ``close()``: call ``close()`` (or use a ``with`` block) at exit or on
    the preemption signal. Every rank of the mesh makes the same calls,
    and only they: the group spans the mesh's ranks, which may be part
    of the default group's (a trainer resumed on fewer ranks)."""

    def __init__(self, path: str, *, mesh=None, max_to_keep: Optional[int] = None) -> None:
        self.path = os.path.abspath(path)
        self.mesh = mesh
        self.max_to_keep = max_to_keep
        self._group = None
        if mesh is not None and dist.is_initialized():
            self._group = dist.new_group(ranks=_mesh_ranks(mesh), backend="gloo",
                                         use_local_synchronization=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: Optional[Future] = None
        self._latest = latest_step(self.path)

    def save(self, step: int, state: TrainState, *, force: bool = False) -> None:
        """Enqueue a save of ``state`` at ``step``; raises if the step is
        at or below the latest (a dropped checkpoint is never silent)."""
        _check_step(self.path, step, self._latest, force)
        sd = _state_dict(state, self.mesh)
        self.wait()
        self._latest = step if self._latest is None else max(self._latest, step)
        self._pending = self._pool.submit(_write, self.path, step, sd, self.mesh,
                                          self._group, force, self.max_to_keep)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.path)

    def restore(self, shard_like: TrainState, step: Optional[int] = None):
        self.wait()
        return restore_checkpoint(self.path, shard_like, step, mesh=self.mesh,
                                  group=self._group)

    def wait(self) -> None:
        """Block until the save in flight (if any) is committed; its
        error, if it failed, raises here."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
