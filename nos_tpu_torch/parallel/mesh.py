"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``nos_tpu/parallel/mesh.py``. The reference's ``Mesh``
is a grid of JAX devices seen by one program; here a mesh is a
``DeviceMesh`` over the processes of the default group, one rank a
process, with the reference's axis names (``dp``, ``sp``, ``tp``, and
``ep`` for experts and ``pp`` for pipeline stages). Each rank runs the
same program on its own block (explicit SPMD), so the helpers below give
a rank its coordinate, the size of an axis and the process group along
it.

``partition_spec`` has no counterpart: nothing here annotates a global
array for a compiler to shard; a rank holds its block and the
collectives are written out (``parallel/comm.py``). ``mesh_for_slice``
builds the reference's ``('dp', 'tp')`` mesh from a slice topology.
Neither it nor ``default_training_mesh`` places ``ep`` or ``pp``, as
the reference's do not: a caller names those axes itself.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nos_tpu_torch import _resolve_device
from nos_tpu_torch.util.topology import Topology

# The axes the port runs, in the reference's order.
AXES = ("dp", "sp", "tp", "ep", "pp")
# The axes default_training_mesh lays out.
TRAINING_AXES = ("dp", "sp", "tp")


def mesh_from_devices(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    device=None,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` over the ranks of the default
    group (initialised first: ``parallel/distributed.py:initialize``),
    on ``cuda`` unless the caller names another device type."""
    need = math.prod(axis_shapes)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(
            f"need {need} devices for mesh {tuple(axis_shapes)}, have {have}"
        )
    return init_device_mesh(_resolve_device(device).type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def default_training_mesh(device=None) -> DeviceMesh:
    """``('dp', 'sp', 'tp')`` over every rank: tp takes 2 where the rank
    count is even, sp 2 where what is left is even, and the rest folds
    into dp (the reference's order: tp innermost, on the fastest links).
    An axis that does not divide the count collapses to 1."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    sp = 2 if rest % 2 == 0 else 1
    return mesh_from_devices((rest // sp, sp, tp), TRAINING_AXES, device)


def mesh_for_slice(topology: str, dp: Optional[int] = None, device=None) -> DeviceMesh:
    """``('dp', 'tp')`` mesh covering one slice: tp takes the last
    (contiguous) topology dimension and the rest folds into dp; an
    explicit ``dp`` sets the split instead (dp·tp is the chip count)."""
    t = Topology(topology)
    chips = t.chips
    if dp is None:
        tp = t.dims[-1]
        dp = chips // tp
    else:
        if chips % dp:
            raise ValueError(f"dp={dp} does not divide {chips} chips")
        tp = chips // dp
    return mesh_from_devices((dp, tp), ("dp", "tp"), device)


def check_mesh_axes(mesh, allowed: Sequence[str] = AXES) -> None:
    """A loud error unless ``mesh`` is a ``DeviceMesh`` whose dims are all
    named, each among ``allowed``: TypeError for anything else in the
    place of a mesh, ValueError for an axis the caller does not run."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"a mesh is a torch DeviceMesh with named axes among {tuple(allowed)}; "
            f"{type(mesh).__name__} is not"
        )
    names = tuple(mesh.mesh_dim_names or ())
    other = [name for name in names if name not in allowed]
    if other or len(names) != mesh.ndim:
        raise ValueError(f"mesh axes {names}: this path runs over {tuple(allowed)} only")


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of axis ``name``; 1 when the mesh is None or lacks it."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along ``name`` (``lax.axis_index``); 0 when
    the mesh is None or lacks the axis."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def mesh_groups(mesh: Optional[DeviceMesh], axes: Sequence[str] = AXES) -> List:
    """The groups of the mesh's axes among ``axes`` that are longer than
    1: an all-reduce over each in turn reduces over those axes (over the
    whole mesh by default)."""
    if mesh is None:
        return []
    return [mesh.get_group(name) for name in mesh.mesh_dim_names
            if name in axes and axis_size(mesh, name) > 1]


def axis_group(mesh: Optional[DeviceMesh], name: str):
    """The process group along ``name`` through this rank, or None when
    the axis is absent or of size 1 (nothing to communicate)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def sub_mesh(mesh: Optional[DeviceMesh], names: Sequence[str]) -> Optional[DeviceMesh]:
    """The mesh over this rank's line or plane along those of ``names``
    that ``mesh`` has longer than 1, in the mesh's order; None when
    there is none. A MoE serving replica on a ``('dp', 'tp', 'ep')``
    mesh runs on its ``('tp', 'ep')`` plane."""
    if mesh is None:
        return None
    keep = tuple(n for n in mesh.mesh_dim_names if n in names and axis_size(mesh, n) > 1)
    if not keep:
        return None
    if keep == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[keep[0]] if len(keep) == 1 else mesh[keep]
