"""Geometry: a multiset of MIG or MPS profiles on one GPU.

Counterpart of ``nos_tpu/tpu/geometry.py`` (the reference's ``gpu.Geometry
= map[Slice]int``, pkg/gpu/partitioning.go:28-143). Profiles are MIG names
("3g.40gb") or MPS memory slices ("20gb"). Where the TPU geometry counts
chips, a MIG geometry counts the two kinds of slice an instance takes:
memory slices (8 on an H100) and compute slices (7).
"""
from __future__ import annotations

from typing import Dict, Tuple

from nos_tpu_torch.gpu.known import mig_profile

Geometry = Dict[str, int]


def geometry_slices(g: Geometry) -> Tuple[int, int]:
    """(memory slices, compute slices) a MIG geometry takes: the
    counterpart of ``geometry_chips``."""
    memory = compute = 0
    for profile, n in g.items():
        p = mig_profile(profile)
        memory += p.memory_slices * n
        compute += p.compute_slices * n
    return memory, compute


def geometry_add(a: Geometry, b: Geometry) -> Geometry:
    out = dict(a)
    for p, n in b.items():
        out[p] = out.get(p, 0) + n
    return {p: n for p, n in out.items() if n != 0}


def geometry_subtract(a: Geometry, b: Geometry) -> Geometry:
    """a - b; negative counts are kept (caller checks with geometry_fits)."""
    out = dict(a)
    for p, n in b.items():
        out[p] = out.get(p, 0) - n
    return {p: n for p, n in out.items() if n != 0}


def geometry_fits(container: Geometry, content: Geometry) -> bool:
    """True when `container` has at least `content` of every profile."""
    return all(container.get(p, 0) >= n for p, n in content.items())
