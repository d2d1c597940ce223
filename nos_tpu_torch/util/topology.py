"""Slice topology strings, trimmed for the mesh constructors.

The port's own copy of the part of ``nos_tpu/tpu/topology.py`` that
``parallel/mesh.py:mesh_for_slice`` needs: a topology such as ``"2x4"``
parsed into its dimensions and its chip count. The slice-tiling search
of the reference stays with the control plane.
"""
from __future__ import annotations

from typing import Tuple


class Topology:
    """A slice topology like ``'2x4'`` or ``'2x2x1'``."""

    __slots__ = ("dims",)

    def __init__(self, spec: "str | Tuple[int, ...]") -> None:
        if isinstance(spec, str):
            try:
                dims = tuple(int(d) for d in spec.split("x"))
            except ValueError as e:
                raise ValueError(f"invalid topology {spec!r}") from e
        else:
            dims = tuple(spec)
        if not dims or any(d < 1 for d in dims):
            raise ValueError(f"invalid topology {spec!r}")
        self.dims = dims

    @property
    def chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def __str__(self) -> str:
        return "x".join(str(d) for d in self.dims)

    def __repr__(self) -> str:
        return f"Topology({str(self)!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Topology) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)
