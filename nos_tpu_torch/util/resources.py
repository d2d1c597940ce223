"""Resource arithmetic over ``{resource: quantity}`` maps: the port's
trimmed copy of ``nos_tpu/util/resources.py`` (reference
pkg/resource/resource.go:30-146).

The reference's pod request is Σ containers ⊔ max of init containers;
the port's pod is already one request map, so ``compute_pod_request``
returns a copy of it. The plain-chip normalization and the aggregate
quota resources serve the TPU mode and the quota slice and are left out
(a plain ``nvidia.com/gpu`` request is never rewritten into a slice,
``gpu/node.py``).
"""
from __future__ import annotations

from typing import Dict, Mapping

ResourceList = Dict[str, int]


def sum_resources(a: Mapping[str, int], b: Mapping[str, int]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def subtract_resources(a: Mapping[str, int], b: Mapping[str, int]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) - v
    return out


def compute_pod_request(pod) -> ResourceList:
    """The pod's effective request."""
    return dict(pod.request)
